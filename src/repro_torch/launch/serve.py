"""Serving launcher: batched decode with the CORE monitor attached, the
reference's ``launch/serve.py`` on PyTorch.

    python -m repro_torch.launch.serve --arch qwen2.5-14b [--smoke]
        [--tokens 32] [--lanes 4] [--prompt-len 8] [--guard "SELECT ..."]
        [--service [--service-dir DIR]] [--device cpu]

Prefill builds the lanes' caches at the prompt's length, which grow to the
prompt plus ``--tokens``; the decode loop emits one CER event per (lane,
token) into the guard, a CEQL query ``PARTITION BY [lane]``; its matches
surface as guardrail hits beside the generated tokens.

The model runs on the CUDA device unless ``--device cpu`` asks for the CPU,
and raises without a card.  ``--smoke`` takes the arch's reduced config;
without it the published config runs whole on one card (Qwen2.5-14B in
bf16 holds 29.5 GB of weights), with no mesh: one card needs no sharding.

Without ``--service`` the guard is the in-process host executor.  With it,
the guard is the :class:`repro_torch.runtime.StreamService` over
``PartitionedStreamingEngine(VectorEngine(q, device=...), ("lane",),
chunk_len=16, num_lanes=max(4, lanes))``: the decode loop submits raw
dicts, the service validates, chunks and encodes them off the decode
thread, and on CUDA each chunk launches the lane router and the fused-scan
kernel; alerts surface through its sinks, backed by a durable emission log
under ``--service-dir`` (a temporary directory when omitted).
"""
from __future__ import annotations

import argparse
import tempfile
import time
from dataclasses import dataclass, field
from typing import Callable, List, Optional

import numpy as np
import torch
import torch.nn.functional as F

from ..configs import ALIASES, get_config, get_smoke_config
from ..core import Event, compile_query
from ..models import init_params, make_serve_step, prefill
from ..models.config import ModelConfig
from ..vector.engine import resolve_device

DEFAULT_GUARD = """
SELECT * FROM Tokens
WHERE TOK AS a ; TOK AS b ; TOK AS c
FILTER a[logp < -2.5] AND b[logp < -2.5] AND c[logp < -2.5]
WITHIN 8 events
PARTITION BY [lane]
"""


def set_matmul_precision() -> None:
    """Matmuls as the reference's einsums compute them: float32 products
    without TF32, and bf16 products reduced in float32 (PyTorch's default
    lets cuBLAS reduce bf16 split-K partial sums in bf16)."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction = False


def grow_caches(caches, tgt: int):
    """Pad every attention cache's sequence axis to ``tgt``."""
    segs = []
    for seg in caches["segments"]:
        mixer = {}
        for k, v in seg["mixer"].items():
            axis = v.ndim - 3                    # (layers, B, S, KV, D)
            pad = [0, 0] * (v.ndim - 1 - axis) + [0, tgt - v.shape[axis]]
            mixer[k] = F.pad(v, pad)
        segs.append(dict(seg, mixer=mixer))
    return dict(caches, segments=segs)


def make_prompt(cfg: ModelConfig, lanes: int, prompt_len: int, device,
                seed: int = 1) -> torch.Tensor:
    """(lanes, prompt_len) token ids drawn from ``seed`` on ``device``."""
    gen = torch.Generator(device=device).manual_seed(seed)
    return torch.randint(0, cfg.vocab_size, (lanes, prompt_len),
                         generator=gen, device=device)


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


@dataclass
class DecodeRun:
    """One greedy decode: ``fed`` (B, S0 + n) the prompt and every token fed
    to a decode step; ``tokens`` and ``logp`` (B, n) the generated tokens
    and their log-probabilities; ``step_logits`` the steps' logits when
    kept; host seconds of the prefill and of each step, each ending in a
    device synchronize."""
    fed: torch.Tensor
    tokens: np.ndarray
    logp: np.ndarray
    prefill_logits: torch.Tensor
    step_logits: Optional[List[torch.Tensor]]
    prefill_s: float
    step_s: List[float] = field(default_factory=list)


def generate(model, cfg: ModelConfig, prompt: torch.Tensor, n_tokens: int,
             *, keep_logits: bool = False,
             on_step: Optional[Callable[[int, np.ndarray, np.ndarray], None]]
             = None) -> DecodeRun:
    """Prefill ``prompt``, then ``n_tokens`` greedy decode steps.
    ``on_step(t, tokens, logp)`` sees each step's (B,) tokens and their
    log-probabilities as they come."""
    device = prompt.device
    B, S0 = prompt.shape
    serve_step = make_serve_step(cfg)
    _sync(device)
    t0 = time.perf_counter()
    logits, caches = prefill(model, cfg, {"tokens": prompt})
    caches = grow_caches(caches, S0 + n_tokens)
    _sync(device)
    prefill_s = time.perf_counter() - t0
    tok = torch.argmax(logits[:, -1, :], dim=-1)[:, None]
    fed, toks, logps, kept, step_s = [prompt], [], [], [], []
    for t in range(n_tokens):
        fed.append(tok)
        t0 = time.perf_counter()
        logits_t, caches = serve_step(model, tok, caches, S0 + t)
        _sync(device)
        step_s.append(time.perf_counter() - t0)
        logp = torch.log_softmax(logits_t.float(), dim=-1)
        tok = torch.argmax(logits_t, dim=-1)[:, None]
        chosen = torch.gather(logp, 1, tok)[:, 0]
        tok_h, logp_h = tok[:, 0].cpu().numpy(), chosen.cpu().numpy()
        toks.append(tok_h)
        logps.append(logp_h)
        if keep_logits:
            kept.append(logits_t)
        if on_step is not None:
            on_step(t, tok_h, logp_h)
    return DecodeRun(
        fed=torch.cat(fed, dim=1), tokens=np.stack(toks, axis=1),
        logp=np.stack(logps, axis=1), prefill_logits=logits,
        step_logits=kept if keep_logits else None, prefill_s=prefill_s,
        step_s=step_s)


def make_guard_service(q, lanes: int, device, directory: str, sinks=()):
    """The compiled guard ``q`` as a :class:`StreamService` over the
    partitioned engine on ``device`` (the launcher's ``--service`` path)."""
    from ..runtime import EventValidator, StreamService
    from ..vector import PartitionedStreamingEngine, VectorEngine
    ve = VectorEngine(q, device=device)
    pse = PartitionedStreamingEngine(ve, q.query.partition_by, chunk_len=16,
                                     num_lanes=max(4, lanes))
    return StreamService(pse, directory,
                         validator=EventValidator(allowed_types={"TOK"}),
                         sinks=list(sinks))


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--tokens", type=int, default=32)
    ap.add_argument("--lanes", type=int, default=4)
    ap.add_argument("--prompt-len", type=int, default=8)
    ap.add_argument("--smoke", action="store_true")
    ap.add_argument("--guard", default=DEFAULT_GUARD)
    ap.add_argument("--service", action="store_true",
                    help="route the guard through the StreamService "
                         "runtime (validation, DLQ, durable alerts) "
                         "instead of the in-process host executor")
    ap.add_argument("--service-dir", default=None, metavar="DIR",
                    help="durable state directory for --service "
                         "(checkpoints, emission log, DLQ); a temp dir "
                         "when omitted")
    ap.add_argument("--device", default=None,
                    help="cpu to run on the CPU; default the CUDA device")
    args = ap.parse_args(argv)

    set_matmul_precision()
    device = resolve_device(args.device)
    arch = ALIASES.get(args.arch, args.arch)
    cfg = get_smoke_config(arch) if args.smoke else get_config(arch)
    model, _ = init_params(cfg, 0, device)
    B = args.lanes
    prompt = make_prompt(cfg, B, args.prompt_len, device)
    q = compile_query(args.guard)

    svc = guard = None
    alerts: list = []
    events: list = []
    fired = 0
    if args.service:
        sdir = args.service_dir or tempfile.mkdtemp(prefix="serve_svc_")
        svc = make_guard_service(q, B, device, sdir,
                                 sinks=[lambda c, h: alerts.extend(h)])
    else:
        guard = q.make_executor(max_enumerate=1)

    def on_step(t, toks, logp):
        nonlocal fired
        for lane in range(B):
            attrs = {"lane": lane, "logp": float(logp[lane]),
                     "tok": int(toks[lane])}
            events.append(attrs)
            if svc is not None:
                svc.submit(dict(attrs, type="TOK"), block=True, timeout=120.0)
            else:
                fired += len(guard.process(Event("TOK", attrs)))

    run = generate(model, cfg, prompt, args.tokens, on_step=on_step)
    out = {"events": events, "run": run}
    if svc is not None:
        svc.drain(pad=True)
        m = svc.metrics
        svc.close()
        print(f"generated {args.tokens} × {B} lanes; "
              f"{len(alerts)} guardrail alerts across {m.chunks} chunks "
              f"(compile_count={svc.engine.compile_count}, durable log "
              f"at {svc.directory})")
        out.update(alerts=alerts, chunks=m.chunks, directory=svc.directory)
    else:
        print(f"generated {args.tokens} × {B} lanes; "
              f"guardrail fired {fired}×")
        out["fired"] = fired
    return out


if __name__ == "__main__":
    main()
