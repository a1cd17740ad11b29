"""Build and load the port's CUDA kernels, and the contract their wrappers
share.

Each ``csrc/*.cu`` file has a plain C interface.  At first use it is compiled
with ``nvcc`` for Hopper (``sm_90a``) into a shared library under the
repository's ``build/`` directory (git-ignored), keyed by a hash of the
source, and loaded with ctypes.  Nothing here runs at import time: this
module imports on machines without CUDA, where only the plain PyTorch
versions of the kernels run.

Every wrapper follows one rule, kept here: a CPU tensor takes the plain
version, a CUDA tensor launches the kernel or raises, any other device
raises (``uses_kernel``); arguments are checked before the launch
(``check_tensor``), and a launch that returns a CUDA error raises while one
that succeeds adds one to the wrapper's ``launches`` (``count_launch``).

Gradients.  A kernel that training differentiates sits in a
``torch.autograd.Function`` whose backward recomputes through the plain
version (``recompute_backward``), as the JAX package's ``custom_vjp``s
recompute through XLA.  A decode kernel has no backward: on a CUDA tensor it
raises when autograd would need one (``refuse_grad``) rather than return a
tensor with no history.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
from pathlib import Path
from typing import Callable, Dict, Optional, Sequence, Tuple

import torch

_PKG = Path(__file__).resolve().parents[1]
CSRC = _PKG / "csrc"
BUILD_DIR = _PKG.parent / "build"
ARCH_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a")

_loaded: Dict[str, Tuple[ctypes.CDLL, str]] = {}


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    cand = Path(home) / "bin" / "nvcc"
    if cand.exists():
        return str(cand)
    raise RuntimeError("nvcc not found: the CUDA kernels build only on a "
                       "machine with the CUDA toolkit")


def _nvcc_cmd(src: Path, out: Path) -> list:
    return [_nvcc(), *ARCH_FLAGS, "-std=c++17", "-O3", "-shared",
            "-Xcompiler", "-fPIC", "-Xptxas", "-v", "-o", str(out), str(src)]


def build(name: str) -> Tuple[ctypes.CDLL, str]:
    """Compile ``csrc/<name>.cu`` (once per source version) and load it.

    Returns (library, ptxas report).  The report lists each kernel's
    registers, shared memory and spills; it is empty when the library
    was already built."""
    return build_all([name])[name]


def build_all(names: Sequence[str]) -> Dict[str, Tuple[ctypes.CDLL, str]]:
    """``build`` for several sources, one ``nvcc`` process each, all
    started together."""
    pending = {}
    for name in names:
        if name in _loaded or name in pending:
            continue
        src = CSRC / f"{name}.cu"
        digest = hashlib.sha1(src.read_bytes()).hexdigest()[:12]
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        lib_path = BUILD_DIR / f"lib{name}-{digest}.so"
        if lib_path.exists():
            _loaded[name] = (ctypes.CDLL(str(lib_path)), "")
            continue
        tmp = lib_path.with_suffix(f".{os.getpid()}.tmp")
        proc = subprocess.Popen(_nvcc_cmd(src, tmp), stdout=subprocess.PIPE,
                                stderr=subprocess.PIPE, text=True)
        pending[name] = (proc, tmp, lib_path)
    failures = []
    for name, (proc, tmp, lib_path) in pending.items():
        _, err = proc.communicate()
        if proc.returncode != 0:
            failures.append(f"nvcc failed for {name}.cu:\n{err}")
            continue
        os.replace(tmp, lib_path)
        _loaded[name] = (ctypes.CDLL(str(lib_path)), err)
    if failures:
        raise RuntimeError("\n".join(failures))
    return {name: _loaded[name] for name in names}


def build_variants(sources: Dict[str, str], out_dir: Path,
                   signatures: Dict[str, Sequence]
                   ) -> Dict[str, Tuple[ctypes.CDLL, str]]:
    """Compile text variants of one kernel source (name -> CUDA C++ text)
    into ``out_dir``, one ``nvcc`` each, all started together, load each
    and declare ``signatures`` as ``bind`` does.  Returns name -> (library,
    ptxas report).  For the scripts that time variants side by side;
    nothing is cached."""
    out_dir.mkdir(parents=True, exist_ok=True)
    procs = {}
    for name, text in sources.items():
        src = out_dir / f"{name}.cu"
        src.write_text(text)
        procs[name] = subprocess.Popen(
            _nvcc_cmd(src, out_dir / f"{name}.so"), stdout=subprocess.PIPE,
            stderr=subprocess.PIPE, text=True)
    libs, failures = {}, []
    for name, proc in procs.items():
        _, err = proc.communicate()
        if proc.returncode != 0:
            failures.append(f"nvcc failed for variant {name}:\n{err}")
            continue
        lib = ctypes.CDLL(str(out_dir / f"{name}.so"))
        libs[name] = (_declare(lib, signatures), err)
    if failures:
        raise RuntimeError("\n".join(failures))
    return libs


def _declare(lib: ctypes.CDLL, signatures: Dict[str, Sequence]
             ) -> ctypes.CDLL:
    for fn, argtypes in signatures.items():
        getattr(lib, fn).restype = ctypes.c_int
        getattr(lib, fn).argtypes = list(argtypes)
    return lib


def bind(name: str, signatures: Dict[str, Sequence]) -> ctypes.CDLL:
    """``build(name)`` and declare its C functions: each returns an int (a
    CUDA error code, or a size) and takes the given ctypes arguments."""
    return _declare(build(name)[0], signatures)


def uses_kernel(t: torch.Tensor, what: str) -> bool:
    """True on a CUDA tensor (launch the kernel), False on a CPU tensor
    (take the plain version); any other device raises."""
    if t.device.type == "cpu":
        return False
    if t.device.type != "cuda":
        raise ValueError(f"no {what} for device {t.device}")
    return True


def check_tensor(name: str, t: torch.Tensor, device: torch.device,
                 shape: Tuple[int, ...], dtype: torch.dtype,
                 aligned: bool = False) -> None:
    """Raise unless ``t`` is a contiguous ``dtype`` tensor of ``shape`` on
    ``device`` (and 16-byte aligned, with ``aligned``)."""
    if t.device != device:
        raise ValueError(f"{name} is on {t.device}, expected {device}")
    if t.dtype != dtype:
        raise TypeError(f"{name} must be {dtype}, got {t.dtype}")
    if tuple(t.shape) != shape:
        raise ValueError(f"{name} must have shape {shape}, got "
                         f"{tuple(t.shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous")
    if aligned and t.data_ptr() % 16:
        raise ValueError(f"{name} must be 16-byte aligned")


def count_launch(wrapper: Callable, err: int) -> None:
    """After a kernel's C entry point returned ``err``: raise on a CUDA
    error, else add one to ``wrapper.launches``."""
    if err != 0:
        raise RuntimeError(f"{wrapper.__name__} launch failed (CUDA error "
                           f"{err})")
    wrapper.launches += 1


def refuse_grad(what: str, *tensors: Optional[torch.Tensor]) -> None:
    """Raise when autograd would have to differentiate a kernel that has no
    backward: grad mode is on and one of ``tensors`` requires a gradient."""
    if torch.is_grad_enabled() and any(
            t is not None and t.requires_grad for t in tensors):
        raise RuntimeError(
            f"{what} has no backward: call it under torch.no_grad() (or "
            "torch.inference_mode()) or on tensors that require no gradient")


def recompute_backward(fn: Callable, inputs: Sequence[torch.Tensor],
                       needs: Sequence[bool], grad: torch.Tensor
                       ) -> Tuple[Optional[torch.Tensor], ...]:
    """The backward of a kernel through its plain version ``fn``: rerun
    ``fn(*inputs)`` with autograd on and return the gradient of each input
    whose ``needs`` entry is True (None for the others, which autograd then
    never computes: a frozen weight costs no dW)."""
    with torch.enable_grad():
        leaves = [t.detach().requires_grad_(n) for t, n in zip(inputs, needs)]
        want = [t for t, n in zip(leaves, needs) if n]
        grads = iter(torch.autograd.grad(fn(*leaves), want, grad)
                     if want else ())
    return tuple(next(grads) if n else None for n in needs)
