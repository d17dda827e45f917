"""Serving launcher: batched decode with the CORE monitor attached, the
reference's ``launch/serve.py`` on PyTorch.

    python -m repro_torch.launch.serve --arch qwen2.5-14b [--smoke]
        [--tokens 32] [--lanes 4] [--prompt-len 8] [--guard "SELECT ..."]
        [--service [--service-dir DIR]] [--device cpu]

Prefill builds the lanes' caches at the prompt's length (after InternVL's
patches, which the prefix holds), which grow by ``--tokens``; Whisper's
prefill also runs the encoder over the frames and keeps each decoder
layer's ``cross_kv``.  The frames (B, 1500, 512) or patches (B, 256, 1024)
stand in for the audio and vision frontends and are drawn from a seeded
generator.  The decode loop emits one CER event per (lane, token) into the
guard, a CEQL query ``PARTITION BY [lane]``; its matches surface as
guardrail hits beside the generated tokens.

The model runs on the CUDA device unless ``--device cpu`` asks for the CPU,
and raises without a card.  ``--smoke`` takes the arch's reduced config
under the mesh of one rank (``data`` 1 × ``model`` 1), as the reference's
launcher runs under ``make_host_mesh()``, with plain tensors.  Without it
the published config runs on the production mesh of the job's world
(``launch.mesh.production_shape``: ``data`` 16 × ``model`` 16 for 256
ranks under ``torchrun``, the mesh of one rank for a world of one; any
other world raises), its weights placed as DTensors by ``DECODE_RULES``
(heads and experts over ``model``, ``fsdp`` over ``data``), the lanes
split over ``data`` and the KV caches' sequence over ``model``.  MoE
layers take the reference's expert-parallel paths on both: at 512 tokens
or fewer (the prefill of 4 × 8, every decode step) the weights-stationary
pass, which drops no token-choice.  On one card, Qwen2.5-14B in bf16
holds 29.5 GB of weights; Granite-MoE-1B, Zamba2-2.7B and RWKV6-1.6B
2.7-4.1 GB; Whisper-base 0.29 GB in float32; InternVL2-1B 0.99 GB.
DeepSeek-V3's published config (about 1.34 TB in bf16) needs the
production mesh of 256 ranks (``python -m repro_torch.launch.dryrun
--arch deepseek-v3-671b --shape decode_32k`` gives what a rank holds); on
one card take it with ``--smoke``.

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
import torch.distributed
import torch.nn.functional as F

from ..configs import ALIASES, get_config, get_smoke_config
from ..core import Event, compile_query
from ..models import init_params, make_serve_step, prefill
from ..models.config import ModelConfig
from ..sharding import (DECODE_RULES, current_rules, full, is_dtensor,
                        set_rules)
from ..sharding.specs import drawn_in_place, place
from ..vector.engine import resolve_device
from .mesh import host_model_mesh, init_production_mesh, use_model_mesh

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
    """Pad each attention cache's sequence axis to ``tgt``, as the
    reference's does: ``k``/``v`` on axis ``ndim - 3`` (stacked ``(layers,
    B, S, KV, D)`` or a shared invocation's ``(B, S, KV, D)``),
    ``c_kv``/``k_rope`` on ``ndim - 2``; every other leaf (Mamba2's
    ``conv``/``state``, RWKV6's ``x_prev``/``state``) stays as it is."""
    def pad(v, axis):
        return F.pad(v, [0, 0] * (v.ndim - 1 - axis)
                     + [0, tgt - v.shape[axis]])

    axis_from_end = {"k": 3, "v": 3, "c_kv": 2, "k_rope": 2}
    segs = []
    for seg in caches["segments"]:
        mixer = {k: pad(v, v.ndim - axis_from_end[k])
                 if k in axis_from_end else v
                 for k, v in seg["mixer"].items()}
        segs.append(dict(seg, mixer=mixer))
    return dict(caches, segments=segs)


def make_prompt(cfg: ModelConfig, lanes: int, prompt_len: int, device,
                seed: int = 1) -> torch.Tensor:
    """(lanes, prompt_len) token ids drawn from ``seed`` on ``device``."""
    gen = torch.Generator(device=device).manual_seed(seed)
    return torch.randint(0, cfg.vocab_size, (lanes, prompt_len),
                         generator=gen, device=device)


def make_frontend(cfg: ModelConfig, lanes: int, device, seed: int = 2
                  ) -> dict:
    """The frontend stub's input, float32 normal draws from ``seed`` on
    ``device``: ``frames`` (lanes, encoder_seq, d_model) for an encoder
    (Whisper), ``patches`` (lanes, frontend_seq, frontend_dim) for the
    vision stub (InternVL), nothing otherwise."""
    gen = torch.Generator(device=device).manual_seed(seed)
    if cfg.encoder_layers:
        shape, key = (lanes, cfg.encoder_seq, cfg.d_model), "frames"
    elif cfg.frontend == "vision_stub":
        shape, key = (lanes, cfg.frontend_seq, cfg.frontend_dim), "patches"
    else:
        return {}
    return {key: torch.randn(shape, generator=gen, device=device)}


def place_model(model, rules, mesh):
    """The model's weights placed as DTensors over ``mesh`` (a
    :class:`~repro_torch.launch.mesh.ModelMesh` with a ``DeviceMesh``) by
    ``rules``, in place; returns the model."""
    return place(model, model.axes, rules, mesh.device_mesh)


def _device_mesh(model):
    """The ``DeviceMesh`` of a model placed as DTensors, else None."""
    w = next(model.parameters())
    return w.device_mesh if is_dtensor(w) else None


def _place_batch(batch: dict, cfg: ModelConfig, dm) -> dict:
    """A batch (tokens and the frontend's input) split over the rules'
    batch axes on ``dm``; as it is off a mesh."""
    if dm is None:
        return batch
    from .specs import batch_axes
    axes = batch_axes(cfg)
    axes["tokens"] = ("batch", None)
    return place(batch, {k: axes[k] for k in batch}, current_rules(), dm)


def _map(fn, tree):
    """``fn`` on each tensor of a cache tree."""
    if isinstance(tree, dict):
        return {k: _map(fn, v) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_map(fn, v) for v in tree]
    return fn(tree) if isinstance(tree, torch.Tensor) else tree


def _grow_placed(caches, tgt: int, cfg: ModelConfig, dm):
    """Prefill's caches grown to ``tgt`` positions (:func:`grow_caches`),
    placed over ``dm`` by the rules and the logical axes of
    ``init_decode_caches`` without a whole copy on any rank: a leaf that
    grows starts as zeros on its placements and takes prefill's positions
    where its block holds them; any other is redistributed.  As
    :func:`grow_caches` off a mesh."""
    if dm is None:
        return grow_caches(caches, tgt)
    from torch.distributed.tensor import zeros

    from ..models import init_decode_caches
    from ..sharding.specs import sharding_tree, to_dtensor, write_at
    shapes = grow_caches(_map(lambda t: torch.empty(
        t.shape, dtype=t.dtype, device="meta"), caches), tgt)
    _, axes = init_decode_caches(cfg, 1, 1, device="meta")
    where = sharding_tree(shapes, axes, current_rules(), dm)

    def go(x, s, p):
        if isinstance(x, dict):
            return {k: go(x[k], s[k], p[k]) for k in x}
        if isinstance(x, list):
            return [go(*a) for a in zip(x, s, p)]
        if not isinstance(x, torch.Tensor):
            return x
        if s.shape == x.shape:
            return (x.redistribute(dm, p) if is_dtensor(x)
                    else to_dtensor(x, dm, p))
        axis = next(d for d in range(x.ndim) if s.shape[d] != x.shape[d])
        dst = zeros(s.shape, dtype=s.dtype, device_mesh=dm, placements=p)
        write_at(dst, axis, 0, x)
        return dst
    return go(caches, shapes, where)


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


@dataclass
class DecodeRun:
    """One greedy decode: ``fed`` (B, S0 + n) the prompt and every token fed
    to a decode step; ``frontend`` the frames or patches given with the
    prompt; ``prefix`` the positions they took before the prompt (InternVL's
    patches); ``tokens`` and ``logp`` (B, n) the generated tokens and their
    log-probabilities; ``prefill_logits`` (B, prefix + S0, V);
    ``step_logits`` the steps' logits when kept; host seconds of the
    prefill and of each step, each ending in a device synchronize."""
    fed: torch.Tensor
    tokens: np.ndarray
    logp: np.ndarray
    prefill_logits: torch.Tensor
    step_logits: Optional[List[torch.Tensor]]
    prefill_s: float
    step_s: List[float] = field(default_factory=list)
    frontend: dict = field(default_factory=dict)
    prefix: int = 0


def generate(model, cfg: ModelConfig, prompt: torch.Tensor, n_tokens: int,
             *, frontend: Optional[dict] = None, keep_logits: bool = False,
             on_step: Optional[Callable[[int, np.ndarray, np.ndarray], None]]
             = None) -> DecodeRun:
    """Prefill ``prompt`` with the ``frontend`` input (``make_frontend``'s
    frames or patches), then ``n_tokens`` greedy decode steps, the first
    at the prefix's length (prompt and patches).  ``on_step(t, tokens,
    logp)`` sees each step's (B,) tokens and their log-probabilities as
    they come.

    A model placed as DTensors (:func:`place_model`, the production mesh)
    takes the prompt, the frontend's input and each step's token split
    over the rules' batch axes; prefill's caches are grown and placed by
    the rules (``cache_seq`` over ``model`` under ``DECODE_RULES``) from
    their blocks, and each step writes them in place on the rank that
    holds the position; the logits are gathered whole on every rank."""
    device = prompt.device
    frontend = dict(frontend or {})
    dm = _device_mesh(model)
    S0 = prompt.shape[1]
    serve_step = make_serve_step(cfg)
    _sync(device)
    t0 = time.perf_counter()
    logits, caches = prefill(model, cfg, _place_batch(
        dict(frontend, tokens=prompt), cfg, dm))
    start = caches["index"]
    caches = _grow_placed(caches, start + n_tokens, cfg, dm)
    logits = full(logits)
    _sync(device)
    prefill_s = time.perf_counter() - t0
    tok = torch.argmax(logits[:, -1, :], dim=-1)[:, None]
    fed, toks, logps, kept, step_s = [prompt], [], [], [], []
    for t in range(n_tokens):
        fed.append(tok)
        t0 = time.perf_counter()
        logits_t, caches = serve_step(
            model, _place_batch({"tokens": tok}, cfg, dm)["tokens"], caches,
            start + t)
        logits_t = full(logits_t)
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
        step_s=step_s, frontend=frontend, prefix=start - S0)


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
    B = args.lanes
    prompt = make_prompt(cfg, B, args.prompt_len, device)
    frontend = make_frontend(cfg, B, device)
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

    # --smoke: the mesh of one rank, as the reference's launcher enters
    # make_host_mesh(); else the production mesh, the weights placed by
    # DECODE_RULES.  MoE layers take the expert-parallel paths on both.
    owns_group = False
    if args.smoke:
        mesh = host_model_mesh()
    else:
        owns_group = not torch.distributed.is_initialized()
        mesh = init_production_mesh(device=device)
    try:
        with set_rules(DECODE_RULES), use_model_mesh(mesh):
            if args.smoke:
                model, _ = init_params(cfg, 0, device)
            else:
                # each weight keeps this rank's block as it is drawn
                with drawn_in_place(cfg, DECODE_RULES, mesh.device_mesh):
                    model, _ = init_params(cfg, 0, device)
            run = generate(model, cfg, prompt, args.tokens,
                           frontend=frontend, on_step=on_step)
    finally:
        if owns_group:
            torch.distributed.destroy_process_group()
    out = {"events": events, "run": run, "mesh": dict(mesh.shape)}
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
