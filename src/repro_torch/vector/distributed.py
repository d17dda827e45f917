"""Distributed CER on ``torch.distributed``: PARTITION BY sharded over ranks.

The counterpart of the reference package's ``vector/distributed.py``,
written for PyTorch's SPMD model: every rank is a process that passes its
own block (:mod:`repro_torch.launch.mesh`), where the reference passes a
global array to ``shard_map``.  Three pieces:

* :func:`sharded_cea_scan` — the windowed counting scan over this rank's
  lanes.  Partitions are independent, so the scan needs no collective.
* :func:`sharded_cer_pipeline` — the fused single-pass pipeline
  (:func:`repro_torch.kernels.ops.cer_pipeline`) over this rank's lanes:
  tables replicated, still no collective, and ``start_pos`` a tensor, so
  one kernel library serves every chunk.
* :func:`route_by_partition` — the event router: each rank bucket-sorts
  its events by the rank owning their partition hash, and one
  ``all_to_all`` moves every bucket to its owner.  This is the one
  collective of the distributed engine.  :func:`route_partitioned_chunk`
  routes one chunk of an interleaved keyed stream with its metadata, for
  :meth:`PartitionedStreamingEngine.feed_keyed
  <repro_torch.vector.partitioned.PartitionedStreamingEngine.feed_keyed>`.

Every function runs its collective at every world size, 1 included.

The router writes only the rows it keeps into the send buffer; the others
go to a scratch row that is never sent.  The reference adds every row,
times its keep flag, into a clipped slot of its destination bucket, so a
dropped or spilled row that carries NaN (the encoder's NULL attribute)
makes NaN of the kept event that owns that slot (``NaN · 0`` is NaN).
Here a dropped row touches no slot; on rows without NaN or infinities
both give equal results.
"""
from __future__ import annotations

from typing import Optional, Sequence, Tuple, Union

import torch
import torch.distributed as dist

from ..core.partition import NULL_KEY_HASH
from ..kernels import ops
from ..kernels import ref as kref
from ..launch.mesh import StreamGroup

_NULL_BITS = int(kref.key_bits(torch.tensor([NULL_KEY_HASH]))[0])


def _on_group_device(group: StreamGroup, *tensors: torch.Tensor) -> None:
    for t in tensors:
        if t.device != group.device:
            raise ValueError(f"rank {group.rank} holds its blocks on "
                             f"{group.device}, got a tensor on {t.device}")


def _start_tensor(start_pos, device) -> torch.Tensor:
    return torch.as_tensor(start_pos, dtype=torch.int32, device=device)


def sharded_cea_scan(group: StreamGroup, class_ids: torch.Tensor,
                     m_all: torch.Tensor, finals: torch.Tensor,
                     c0: torch.Tensor, *, epsilon: int,
                     start_pos: Union[int, torch.Tensor] = 0
                     ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The single-query scan over this rank's lanes.

    class_ids (T, B/n) int32 and c0 (B/n, W, S): this rank's block of the
    lane axis | m_all, finals replicated | start_pos one scalar for every
    lane → (matches (T, B/n), c_final (B/n, W, S)), this rank's block of
    the reference's global result.  No collective.  On CUDA it launches
    the scan kernel (:func:`repro_torch.kernels.ops.cea_scan`).
    """
    _on_group_device(group, class_ids, c0)
    return ops.cea_scan(class_ids, m_all, finals, c0, epsilon=epsilon,
                        start_pos=_start_tensor(start_pos, c0.device))


def sharded_cer_pipeline(group: StreamGroup, attrs: torch.Tensor,
                         specs: Sequence[Tuple[int, int, float]],
                         class_of: torch.Tensor, class_ind: torch.Tensor,
                         m_all: torch.Tensor, finals_q: torch.Tensor, c0,
                         *, init_mask: torch.Tensor, epsilon: int,
                         start_pos: Union[int, torch.Tensor] = 0,
                         impl: str = "fused", inplace: bool = False
                         ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The fused pipeline over this rank's lanes.

    attrs (T, B/n, A) and c0 (B/n, W, S): this rank's block | tables
    replicated → (matches (T, B/n, Q), c_final (B/n, W, S)).  No
    collective: every rank runs the pipeline on its own substreams.  On
    CUDA ``impl="fused"`` launches the fused-scan kernel.
    """
    _on_group_device(group, attrs, c0)
    return ops.cer_pipeline(attrs, tuple(specs), class_of, class_ind, m_all,
                            finals_q, c0, init_mask=init_mask,
                            epsilon=epsilon,
                            start_pos=_start_tensor(start_pos, attrs.device),
                            impl=impl, inplace=inplace)


def bucket_rows(keys: torch.Tensor, drop: Optional[torch.Tensor],
                n_shards: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """The local bucket sort of the router.

    keys (N,) integer partition hashes (owner ``keys % n_shards``, Python's
    sign rule); drop (N,) bool or None.  Each destination's bucket holds
    ``cap = N // n_shards`` rows.  Returns ``(slot, keep)``: a kept row's
    slot in the ``(n_shards·cap,)`` send buffer is ``dest·cap`` plus its
    rank among the earlier live rows of its destination; keep is False for
    dropped rows and rows past ``cap``, whose slot is ``n_shards·cap``, a
    scratch row past the buffer that is never sent.  No host sync.
    """
    N = keys.shape[0]
    cap = N // n_shards
    dest = torch.remainder(keys.to(torch.int64), n_shards)
    live = torch.ones_like(dest, dtype=torch.bool) if drop is None \
        else ~drop.to(torch.bool)
    onehot = (dest[:, None] == torch.arange(n_shards, device=dest.device)) \
        & live[:, None]
    rank = onehot.cumsum(0).gather(1, dest[:, None])[:, 0] - 1
    keep = live & (rank < cap)
    return torch.where(keep, dest * cap + rank, n_shards * cap), keep


def pack_rows(cols: torch.Tensor, slot: torch.Tensor,
              n_shards: int) -> torch.Tensor:
    """The send buffer ``(n_shards·cap, P)`` int32: the kept rows of
    ``cols`` (N, P) int32 at their slots (:func:`bucket_rows`), zeros
    elsewhere.  Dropped and spilled rows land in the scratch row past the
    buffer, which is cut off."""
    N, P = cols.shape
    rows = n_shards * (N // n_shards)
    send = torch.zeros((rows + 1, P), dtype=torch.int32, device=cols.device)
    return send.index_copy_(0, slot, cols)[:rows]


def exchange_rows(group: StreamGroup, send: torch.Tensor) -> torch.Tensor:
    """One ``all_to_all``: bucket ``s`` of this rank's ``send`` goes to rank
    ``s``, which stores it as its bucket ``r`` (``lax.all_to_all`` with
    ``split_axis=0, concat_axis=0, tiled=False``)."""
    recv = torch.empty_like(send)
    dist.all_to_all_single(recv, send, group=group.group)
    return recv


def route_by_partition(group: StreamGroup, events: torch.Tensor,
                       keys: torch.Tensor,
                       payload: Optional[torch.Tensor] = None,
                       drop: Optional[torch.Tensor] = None):
    """Route this rank's event rows to the ranks owning their partitions.

    events (N, A) f32: this rank's block, with ``N`` divisible by the world
    size ``n`` | keys (N,) integer partition hashes (owner ``keys % n``) |
    payload optional (N, P) int32 columns routed through the same
    permutation | drop optional (N,) bool: rows excluded sender-side (NULL
    partition keys), which take no bucket capacity and come back
    ``keep=False``.

    Each rank sends ``n`` buckets of ``cap = N // n`` rows; a bucket's
    rows past ``cap`` spill (``keep=False``, for a host retry).  Returns
    ``(routed, keep)`` or ``(routed, routed_payload, keep)``: routed
    ``(n·cap, A)`` holds in bucket ``s`` the rows rank ``s`` sent here, in
    its local order, then zero rows; ``keep`` (N,) flags the rows that
    arrived at their owner.  Gathered in rank order, the outputs are the
    reference's for the global array.  Events, payload and ownership
    travel in one ``all_to_all`` of one int32 buffer.
    """
    n = group.world_size
    N, A = events.shape
    if N % n:
        raise ValueError(f"route_by_partition needs a block of rows "
                         f"divisible by the world size {n}, got {N}")
    if events.dtype != torch.float32:
        raise ValueError(f"events are f32, got {events.dtype}")
    _on_group_device(group, events, keys)
    cols = [events.contiguous().view(torch.int32)]
    if payload is not None:
        cols.append(payload.to(torch.int32))
    slot, keep = bucket_rows(keys, drop, n)
    recv = exchange_rows(group, pack_rows(torch.cat(cols, 1), slot, n))
    routed = recv[:, :A].contiguous().view(torch.float32)
    if payload is None:
        return routed, keep
    return routed, recv[:, A:].contiguous(), keep


def route_partitioned_chunk(group: StreamGroup, attrs: torch.Tensor,
                            keys, positions: torch.Tensor,
                            event_ts: Optional[torch.Tensor] = None):
    """This rank's block of one chunk of an interleaved stream → the
    sub-chunk of the partitions this rank owns.

    Rank ``s`` owns the partitions with ``hash % n == s`` (reduced in
    uint32, so hashes ≥ 2^31 land on their owner), so the router is the
    only collective of the partitioned pipeline: each rank then runs its
    own lane router and fused scan on its sub-chunk
    (:meth:`PartitionedStreamingEngine.feed_keyed
    <repro_torch.vector.partitioned.PartitionedStreamingEngine.feed_keyed>`
    with ``positions=``).

    attrs (N, A) f32 | keys (N,) 32-bit partition hashes (uint32, int32
    bits or int64 values) | positions (N,) int global stream positions |
    event_ts (N,) f32 (time windows; one more payload column, as bits).
    Returns ``(attrs', keys', positions', valid, keep)``, with ``ts'``
    before ``valid`` when ``event_ts`` was given: row i of every output is
    one received row.  ``keys'`` is uint32; padding rows carry
    ``NULL_KEY_HASH`` and position 0, and ``valid`` is False there.
    ``keep`` (N,) flags the sent rows that arrived: NULL-keyed rows drop
    before the exchange, rows past a bucket's capacity spill.
    """
    n = group.world_size
    bits = kref.key_bits(keys).to(attrs.device)
    dest = ((bits.to(torch.int64) & 0xFFFFFFFF) % n).to(torch.int32)
    cols = [bits, positions.to(device=attrs.device, dtype=torch.int32),
            torch.ones_like(bits)]
    if event_ts is not None:
        cols.append(torch.as_tensor(event_ts, dtype=torch.float32,
                                    device=attrs.device).view(torch.int32))
    routed, pl, keep = route_by_partition(
        group, attrs, dest, payload=torch.stack(cols, 1),
        drop=bits == _NULL_BITS)
    valid = pl[:, 2] > 0
    keys_out = torch.where(valid, pl[:, 0], _NULL_BITS).view(torch.uint32)
    out = (routed, keys_out, pl[:, 1].contiguous())
    if event_ts is not None:
        out += (pl[:, 3].contiguous().view(torch.float32),)
    return out + (valid, keep)
