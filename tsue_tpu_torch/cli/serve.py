"""Serving command: trajectory prediction and context generation over
``tsue_tpu_torch.serve.Predictor`` (the port's ``scripts/serve.py``).

Batch mode (default): tracks in (pickle or synthetic fixture), predictions
out as JSONL:

    python -m tsue_tpu_torch.cli serve --ckpt runs/train_18_30/ckpt/best \\
        --preset train_18_30 --data all_data.pkl --out preds.jsonl \\
        --candidates 10

HTTP mode: a localhost JSON API, every generation width run once at
startup:

    python -m tsue_tpu_torch.cli serve --ckpt ... --port 8000
    # GET  /healthz   -> {"status": "ok", "model", "batch_size",
    #                     "candidates"}
    # POST /predict   {"tracks": [{track dict}]} ->
    #                 {"results": [{track_id, past_pixel_xy, pred_pixel_xy
    #                   [, candidates_pixel_xy]}]}
    # POST /generate  {"tracks": [...], "max_new_tokens": N} ->
    #                 {"results": [{track_id, context} | {track_id, error}]}
    #                 (N clamped to [1, --max-new-tokens] and served by
    #                 trimming a decode of --max-new-tokens steps)
    # Tracks that produce no result row (all windows filtered) are listed
    # in "dropped_track_ids"; an unknown path is a 404, a failed request a
    # 500 with {"error": "Type: message"}.

Track dicts use the all_data.pkl schema: raw_trajectory (N, 2),
vision_embeddings (N, vision_dim), context_str, lane_roi, track_id (nested
JSON lists over HTTP).

Without --ckpt the predictor serves the random weights that
``runner.build_model_and_params`` makes from the preset's seed (the JAX
script initialises from key 0; see ROADMAP C).  --batcher continuous
serves /generate through the continuous slot-pool batcher
(``serve_batching.py``), which refuses --fused-head.  --speculative
decodes /generate and --generate with prompt-lookup speculative decoding
(``eval/speculative.py``) through either batcher: greedy on the static one
(the plain head), the window mode of the continuous one (a request's ids
are the plain pool's).

Sharded serving: launched by torchrun (``python -m torch.distributed.run
--nproc_per_node N -m tsue_tpu_torch.cli serve ...``; NCCL on the card,
gloo with --device cpu), every rank builds the predictor over a (data,
model) mesh, --model-parallel N ranks to a tensor-parallel group (N must
divide the world size) and --fsdp sharding the large parameters over data
(it needs --model-parallel).  Batch mode: every rank runs, rank 0 writes.
HTTP mode: rank 0 listens and parses each request, broadcasts it to every
rank, every rank runs it, rank 0 answers; a rank on which a request fails
logs it and exits, which ends the job.
"""
from __future__ import annotations

import json
import logging
import threading
from collections import Counter
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

import numpy as np
import torch

from tsue_tpu_torch.cli._common import (add_mesh_args, apply_overrides,
                                        base_parser, check_mesh_args, finish,
                                        setup_mesh)

log = logging.getLogger(__name__)


def build_predictor(args, cfg, mesh=None):
    """The Predictor the flags ask for: over the ``--ckpt`` artifact
    (``Predictor.from_checkpoint``), or over the random weights of
    ``runner.build_model_and_params``; on ``mesh`` when one is given."""
    from tsue_tpu_torch.data import get_tokenizer
    from tsue_tpu_torch.runner import build_model_and_params
    from tsue_tpu_torch.serve import Predictor
    device = mesh.device if mesh is not None else args.device
    kw = dict(batch_size=args.serve_batch_size,
              num_candidates=args.candidates,
              tokenizer=get_tokenizer(args.tokenizer),
              quantize_decode=args.quantize_decode,
              fused_head=args.fused_head, quantize_kv=args.quantize_kv,
              device=device, mesh=mesh, fsdp=args.fsdp)
    if args.ckpt:
        return Predictor.from_checkpoint(cfg, args.ckpt,
                                         mllm_ckpt=args.mllm_ckpt, **kw)
    model = build_model_and_params(cfg, kw["tokenizer"], device,
                                   args.mllm_ckpt)
    return Predictor(cfg.replace(model=model.cfg), model.state_dict(), **kw)


def _jsonable(rec):
    return {k: (v.tolist() if isinstance(v, np.ndarray) else v)
            for k, v in rec.items()}


def _load_tracks(args, cfg):
    from tsue_tpu_torch.data import load_tracks, make_synthetic_tracks
    if args.data:
        return load_tracks(args.data)
    return make_synthetic_tracks(num_tracks=args.synthetic_tracks,
                                 vision_dim=cfg.data.vision_dim,
                                 seed=cfg.data.split_seed)


def _track_id(t):
    """The ingest paths' track-id coercion: track_id, else id, else -1
    when unparseable."""
    tid = t.get("track_id", t.get("id", -1))
    try:
        return int(tid)
    except (TypeError, ValueError):
        return -1


def _coerce_tracks(raw):
    """JSON track dicts -> numpy-backed dicts (HTTP request bodies)."""
    out = []
    for t in raw:
        t = dict(t)
        for k in ("raw_trajectory", "vision_embeddings"):
            if k in t:
                t[k] = np.asarray(t[k], np.float32)
        out.append(t)
    return out


def _dropped(tracks, results):
    """Ids of request tracks with no result row, counted per id: two
    tracks sharing an id (or unparseable ids, all -1) must not hide a
    dropped one behind a served one."""
    got = Counter(r.get("track_id") for r in results)
    dropped = []
    for t in (_track_id(x) for x in tracks):
        if got[t] > 0:
            got[t] -= 1
        else:
            dropped.append(t)
    return dropped


def parse_request(args, path: str, req: dict):
    """A /predict or /generate request body -> ``(path, tracks,
    max_new_tokens)``: the tracks coerced, the length clamped to the
    startup cap.  Under a mesh rank 0 parses before it broadcasts, so a
    malformed body is answered without the other ranks."""
    tracks = _coerce_tracks(req.get("tracks", []))
    mnt = max(1, min(int(req.get("max_new_tokens", args.max_new_tokens)),
                     args.max_new_tokens))
    return path, tracks, mnt


def run_request(predictor, args, path: str, tracks, max_new_tokens: int):
    """One parsed request's results (every rank of a mesh runs it); a
    /generate request decodes the startup cap's steps and trims the rows
    (compile_cap)."""
    if path == "/predict":
        return predictor.predict(tracks)
    gen = (predictor.generate_context_batched
           if args.batcher == "continuous" else predictor.generate_context)
    return gen(tracks, max_new_tokens=max_new_tokens,
               compile_cap=args.max_new_tokens, speculative=args.speculative)


def follow(predictor, args) -> None:
    """A non-zero rank's serving loop under a mesh: run each request that
    rank 0 broadcasts, until it broadcasts None.  A request that fails
    here is logged and its error raised: the ranks are out of step (rank 0
    may wait in a collective this rank will not join), so the process
    ends, its connections close, rank 0's collective fails and that
    request is answered 500, and torchrun ends the job."""
    from tsue_tpu_torch.parallel.mesh import broadcast_object
    while True:
        msg = broadcast_object(None)
        if msg is None:
            return
        try:
            run_request(predictor, args, *msg)
        except Exception:
            log.exception("rank %d: the %s request failed; leaving the mesh",
                          torch.distributed.get_rank(), msg[0])
            raise


def make_server(predictor, args) -> ThreadingHTTPServer:
    """The HTTP API over ``predictor`` on 127.0.0.1:``args.port`` (0: any
    free port), not yet serving: run ``serve_forever`` (in a thread, for a
    test), then ``shutdown`` and ``server_close``.  Requests are served one
    at a time (one lock); ``args`` gives ``max_new_tokens`` (the cap a
    /generate request is clamped to, and the decode length it is served
    by) and ``batcher``.  Under a mesh (rank 0 only) each request is
    broadcast to the other ranks (``follow``) before it runs."""
    from tsue_tpu_torch.parallel.mesh import broadcast_object, distributed
    lock = threading.Lock()

    class Handler(BaseHTTPRequestHandler):
        def _reply(self, code, payload):
            body = json.dumps(payload).encode()
            self.send_response(code)
            self.send_header("Content-Type", "application/json")
            self.send_header("Content-Length", str(len(body)))
            self.end_headers()
            self.wfile.write(body)

        def log_message(self, *a):          # quiet access log
            pass

        def do_GET(self):
            if self.path == "/healthz":
                self._reply(200, {"status": "ok",
                                  "model": predictor.cfg.name,
                                  "batch_size": predictor.batch_size,
                                  "candidates": predictor.num_candidates})
            else:
                self._reply(404, {"error": f"unknown path {self.path}"})

        def do_POST(self):
            try:
                # read the body whatever the path: closing with unread
                # bytes resets the connection, and the client may lose
                # the reply
                n = int(self.headers.get("Content-Length", 0))
                raw = self.rfile.read(n)
                if self.path not in ("/predict", "/generate"):
                    self._reply(404, {"error": f"unknown path {self.path}"})
                    return
                msg = parse_request(args, self.path,
                                    json.loads(raw or b"{}"))
                tracks = msg[1]
                with lock:
                    if distributed():
                        broadcast_object(msg)
                    res = run_request(predictor, args, *msg)
                payload = {"results": [_jsonable(r) for r in res]}
                dropped = _dropped(tracks, res)
                if dropped:
                    payload["dropped_track_ids"] = dropped
                self._reply(200, payload)
            except Exception as e:  # noqa: BLE001 -- the server keeps serving
                self._reply(500, {"error": f"{type(e).__name__}: {e}"})

    return ThreadingHTTPServer(("127.0.0.1", args.port), Handler)


def parser():
    p = base_parser(__doc__)
    p.add_argument("--preset", default="train_18_30")
    p.add_argument("--ckpt", default=None, help="trained checkpoint dir "
                   "(random weights from the preset's seed when absent)")
    p.add_argument("--mllm-ckpt", default=None,
                   help="stage-1 MLLM artifact (frozen-regime checkpoints "
                        "omit the frozen subset)")
    p.add_argument("--candidates", type=int, default=0,
                   help="K MC-dropout candidates per prediction (0 = off)")
    p.add_argument("--serve-batch-size", type=int, default=16,
                   help="fixed batch size (and the continuous batcher's "
                        "slots)")
    p.add_argument("--quantize-decode", action="store_true",
                   help="int8 decode weights for generation")
    p.add_argument("--quantize-kv", action="store_true",
                   help="int8 KV caches for generation")
    p.add_argument("--fused-head", action="store_true",
                   help="decode the static batcher through the fused "
                        "LM-head + top-k kernel (the continuous batcher "
                        "refuses it)")
    p.add_argument("--speculative", action="store_true",
                   help="prompt-lookup speculative decoding for /generate "
                        "and --generate; composes with --batcher "
                        "continuous (window mode, the plain pool's ids)")
    p.add_argument("--batcher", default="static",
                   choices=("static", "continuous"),
                   help="generation scheduling: static batches or the "
                        "continuous slot-pool batcher")
    add_mesh_args(p)
    p.add_argument("--max-new-tokens", type=int, default=64)
    p.add_argument("--generate", action="store_true",
                   help="batch mode: generate context text instead of "
                        "trajectories")
    p.add_argument("--out", default=None, help="batch mode: output JSONL "
                   "path (default stdout)")
    p.add_argument("--port", type=int, default=None,
                   help="start the HTTP API on 127.0.0.1:PORT (0: any free "
                        "port) instead of batch mode")
    return p


def main(argv=None) -> dict:
    p = parser()
    args = p.parse_args(argv)
    check_mesh_args(p, args)
    if args.batcher == "continuous" and args.fused_head:
        raise ValueError("--batcher continuous does not take --fused-head: "
                         "the continuous batcher samples from the full "
                         "logits")
    from tsue_tpu_torch.config import get_preset
    cfg = apply_overrides(get_preset(args.preset), args)
    mesh = setup_mesh(args)
    predictor = build_predictor(args, cfg, mesh)
    primary = mesh is None or mesh.is_primary()

    if args.port is not None:
        predictor.warmup()
        if cfg.model.use_llm:
            predictor.prepare_generation(
                args.max_new_tokens, speculative=args.speculative,
                batched=(args.batcher == "continuous"))
        if not primary:
            follow(predictor, args)
            return {"served": True}
        srv = make_server(predictor, args)
        # tests and supervisors sync on this line
        print(f"SERVING port={srv.server_address[1]}", flush=True)
        try:
            srv.serve_forever()
        except KeyboardInterrupt:
            pass
        finally:
            srv.server_close()
            if mesh is not None:
                from tsue_tpu_torch.parallel.mesh import broadcast_object
                broadcast_object(None)
        return {"served": True}

    tracks = _load_tracks(args, cfg)
    if args.generate:
        gen = (predictor.generate_context_batched
               if args.batcher == "continuous" else predictor.generate_context)
        results = gen(tracks, max_new_tokens=args.max_new_tokens,
                      speculative=args.speculative)
    else:
        results = predictor.predict(tracks)
    lines = [json.dumps(_jsonable(r)) for r in results]
    if not primary:
        return {"results": len(results), "out": args.out,
                "mode": "generate" if args.generate else "predict"}
    if args.out:
        with open(args.out, "w") as f:
            f.write("\n".join(lines) + "\n")
    else:
        for ln in lines:
            print(ln)
    return finish({"results": len(results), "out": args.out,
                   "mode": "generate" if args.generate else "predict"})


if __name__ == "__main__":
    main()
