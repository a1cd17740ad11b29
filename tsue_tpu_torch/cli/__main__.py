"""``python -m tsue_tpu_torch.cli <command> [flags]``: run one command's
``main`` (see the package docstring)."""
import importlib
import sys

from tsue_tpu_torch.cli import COMMANDS


def main(argv=None):
    """Run the command; under torchrun every rank then leaves the process
    group together (``parallel.mesh.leave_distributed``)."""
    argv = list(sys.argv[1:] if argv is None else argv)
    if not argv or argv[0] not in COMMANDS:
        sys.exit(f"usage: python -m tsue_tpu_torch.cli "
                 f"{{{','.join(COMMANDS)}}} [flags]")
    out = importlib.import_module(f"tsue_tpu_torch.cli.{argv[0]}").main(
        argv[1:])
    from tsue_tpu_torch.parallel.mesh import leave_distributed
    leave_distributed()
    return out


if __name__ == "__main__":
    main()
