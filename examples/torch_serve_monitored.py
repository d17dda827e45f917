"""Batched serving with an always-on CER monitor over the token stream, on
the PyTorch port.

The decode loop emits one event per generated token per request lane
(token id, logprob); a CEQL query runs as a real-time guardrail: "3
low-confidence tokens in a row within 8 positions" per request — the
partition-by operator maps requests to independent substreams exactly like
the paper's stock symbols.

    PYTHONPATH=src python examples/torch_serve_monitored.py [--tokens 48]
        [--service] [--device cpu]

The model and the guard's engines run on the CUDA device (the lane-routing
and fused-scan kernels) unless ``--device cpu`` asks for the CPU and the
plain PyTorch versions.  ``--service`` routes the same token stream through
the resilient :class:`repro_torch.runtime.StreamService` instead of the
in-process host executor, and asserts the full contract end to end — exit
is nonzero on any mismatch:

* raw dict events are validated at the door; injected malformed events
  land in the dead-letter queue with reasons, and never reach the engine;
* the device engine's per-position match counts (read back from the
  service's durable emission log) are identical to the paper's host
  dict-of-engines baseline over the same stream;
* a burst variant with a deliberately undersized event ring forces a
  ``WindowOverflowError`` mid-stream: the service quarantines, regrows,
  and replays, and its cumulative emitted match record must equal a
  service whose engine was sized large from the start.

It is ``examples/serve_monitored.py`` on the port.
"""
import argparse
import dataclasses
import sys
import tempfile

import numpy as np

from repro_torch.configs import get_config
from repro_torch.core import Event, compile_query
from repro_torch.launch.serve import (generate, make_prompt,
                                      set_matmul_precision)
from repro_torch.models import init_params
from repro_torch.vector.engine import resolve_device

GUARD = """
SELECT * FROM Tokens
WHERE TOK AS a ; TOK AS b ; TOK AS c
FILTER a[logp < -2.5] AND b[logp < -2.5] AND c[logp < -2.5]
WITHIN 8 events
PARTITION BY [lane]
"""

# burst variant for the self-heal leg: a TIME window over the decode step
# clock, so the ring occupancy depends on the stream (and can overflow)
BURST_GUARD = """
SELECT * FROM Tokens
WHERE TOK AS a ; TOK AS b ; TOK AS c
FILTER a[logp < -2.5] AND b[logp < -2.5] AND c[logp < -2.5]
WITHIN 16 [t]
PARTITION BY [lane]
"""


def tiny_serving_config():
    cfg = get_config("qwen2p5_14b")
    return dataclasses.replace(
        cfg, num_layers=2, d_model=256, num_heads=4, num_kv_heads=2,
        head_dim=64, d_ff=512, vocab_size=4096,
        dtype="float32", param_dtype="float32", remat=False)


def decode_token_events(tokens: int, lanes: int, device=None, model=None,
                        prompt=None):
    """Run the tiny serving stack; return one raw dict event per
    (step, lane) in stream order — the shape a service producer sees.

    ``model`` and ``prompt`` replace the weights drawn from seed 0 and the
    (lanes, 8) prompt drawn from seed 1 (a test hands in the reference's,
    through :func:`repro_torch.models.params_from_jax`)."""
    cfg = tiny_serving_config()
    dev = resolve_device(device)
    if model is None:
        model, _ = init_params(cfg, 0, dev)
    if prompt is None:
        prompt = make_prompt(cfg, lanes, 8, dev)
    raws = []

    def on_step(t, toks, logp):
        for lane in range(lanes):
            raws.append({"type": "TOK", "lane": lane, "t": float(t),
                         "logp": float(logp[lane]), "tok": int(toks[lane])})

    generate(model, cfg, prompt.to(dev), tokens, on_step=on_step)
    return raws


def run_host_guard(raws) -> list:
    guard = compile_query(GUARD).make_executor(max_enumerate=1)
    fired = []
    for i, r in enumerate(raws):
        ev = Event("TOK", {"lane": r["lane"], "logp": r["logp"],
                           "tok": r["tok"]})
        for match in guard.process(ev):
            fired.append((r["lane"], i // 1, match.time))
    return fired


def run_service_demo(raws, lanes: int, device=None) -> None:
    from repro_torch.core.engine import Engine
    from repro_torch.core.partition import PartitionedEngine
    from repro_torch.runtime import (EventValidator, StreamService,
                                     cumulative_matches)
    from repro_torch.vector import PartitionedStreamingEngine, VectorEngine

    chunk = 16
    q = compile_query(GUARD)
    keys = q.query.partition_by                       # ("lane",)

    # ---- host oracle: the paper's dict-of-engines baseline ------------
    pe = PartitionedEngine(
        lambda: Engine(q.cea, window=q.query.window), keys)
    host_counts = [len(pe.process(Event("TOK", {k: v for k, v in r.items()
                                                if k != "type"})))
                   for r in raws]

    # ---- service: raw dicts + injected junk ---------------------------
    junk = [{"type": "NOPE", "lane": 0, "logp": 0.0},
            "not-an-event",
            {"type": "TOK", "lane": 0, "logp": [1, 2]}]
    feed = list(raws)
    for j, bad in enumerate(junk):                    # spread through stream
        feed.insert(len(feed) // 2 + j * 3, bad)

    ve = VectorEngine(q, device=device)
    pse = PartitionedStreamingEngine(ve, keys, chunk_len=chunk,
                                     num_lanes=max(4, lanes))
    with tempfile.TemporaryDirectory() as d:
        svc = StreamService(
            pse, d, validator=EventValidator(allowed_types={"TOK"}))
        receipts = [svc.submit(r, block=True, timeout=120.0) for r in feed]
        svc.drain(pad=True)
        rejected = [r for r in receipts if r.status == "rejected"]
        assert len(rejected) == len(junk), [r.status for r in rejected]
        assert [r["reason"] for r in svc.dlq.records] == \
            ["unknown_type", "not_a_dict", "bad_attr_value"], \
            svc.dlq.records
        # per-position counts, read back from the durable emission log
        dev_counts = np.zeros(svc.metrics.chunks * chunk, np.int64)
        for rec in svc.runner.log.records:
            for idx, v in rec["counts"]:
                dev_counts[rec["chunk"] * chunk + idx[0]] = v
        np.testing.assert_array_equal(dev_counts[:len(raws)],
                                      np.asarray(host_counts))
        assert not dev_counts[len(raws):].any()       # pads are inert
        # one library load on the card, none for the plain versions
        want_compiles = 1 if ve.device.type == "cuda" else 0
        assert pse.compile_count == want_compiles, pse.compile_count
        print(f"service ≡ host baseline: {int(dev_counts.sum())} matches "
              f"over {len(raws)} events, {len(rejected)} malformed events "
              f"dead-lettered, compile_count={pse.compile_count}")
        svc.close()

    # ---- overflow self-heal: undersized ring vs sized-large oracle ----
    qb = compile_query(BURST_GUARD)

    def run(mwe, directory):
        veb = VectorEngine(qb, max_window_events=mwe, device=device)
        eng = PartitionedStreamingEngine(veb, keys, chunk_len=chunk,
                                         num_lanes=max(4, lanes),
                                         strict_overflow=True)
        alerts = []
        svc = StreamService(eng, directory,
                            sinks=[lambda c, h: alerts.append((c, list(h)))],
                            checkpoint_every=4, max_window_events_cap=256)
        for r in raws:
            svc.submit(r, block=True, timeout=120.0)
        svc.drain(pad=True)
        m = svc.metrics
        svc.close()
        return alerts, m, eng

    with tempfile.TemporaryDirectory() as d1, \
            tempfile.TemporaryDirectory() as d2:
        a_small, m_small, eng_small = run(8, d1)
        a_big, m_big, _ = run(64, d2)
        assert m_small.overflows >= 1 and m_small.regrows >= 1, m_small
        assert m_big.overflows == 0, m_big
        hits = lambda al: sorted(h for _, hs in al for h in hs)
        assert hits(a_small) == hits(a_big)
        assert cumulative_matches(d1) == cumulative_matches(d2)
        print(f"overflow self-heal: ring 8 → {eng_small.window.ring} after "
              f"{m_small.overflows} overflow(s) / {m_small.regrows} "
              f"regrow(s), {m_small.replayed_chunks} chunks replayed; "
              f"match record ≡ engine sized large from the start")


def main(argv=None) -> None:
    if sys.flags.optimize:
        # the --service legs verify with asserts; running optimized would
        # silently skip every gate
        raise SystemExit("run without -O: this example verifies with asserts")
    ap = argparse.ArgumentParser()
    ap.add_argument("--tokens", type=int, default=48)
    ap.add_argument("--lanes", type=int, default=4)
    ap.add_argument("--service", action="store_true",
                    help="route the stream through the resilient "
                         "StreamService runtime and verify the full "
                         "contract (DLQ, host parity, overflow self-heal)")
    ap.add_argument("--device", default=None,
                    help="cpu for the CPU and the plain PyTorch versions; "
                         "default the CUDA device")
    args = ap.parse_args(argv)

    set_matmul_precision()
    raws = decode_token_events(args.tokens, args.lanes, args.device)
    print(f"generated {args.tokens} tokens × {args.lanes} lanes")

    if args.service:
        run_service_demo(raws, args.lanes, args.device)
        return

    fired = run_host_guard(raws)
    print(f"guardrail fired {len(fired)} times; first 5: {fired[:5]}")


if __name__ == "__main__":
    main()
