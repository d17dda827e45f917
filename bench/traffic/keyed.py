"""One interleaved stream keyed by ``uid``: each event draws its key
uniformly from ``uids`` accounts, or NULL with probability
``null_share``, and its type uniformly from the cell's ``types``.

Keys are fixed 32-bit hashes of the account numbers (the same for every
seed); the seed draws which account and which type each event has.  The
pool holds ``pool_chunks`` chunks of ``chunk`` events, made on the device
in a few calls; feed ``k`` sends chunk ``k % pool_chunks``.
"""
import torch

#: partition hashes a caller may not use: the program's NULL key and its
#: empty lane-table slot
RESERVED = (0xFFFFFFFF, 0xFFFFFFFE)


def account_hashes(n: int) -> torch.Tensor:
    """(n,) int64: the murmur3 finaliser of 1..n, distinct 32-bit values,
    none of them reserved."""
    h = torch.arange(1, n + 1, dtype=torch.int64)
    m = 0xFFFFFFFF
    h ^= h >> 16
    h = (h * 0x85EBCA6B) & m
    h ^= h >> 13
    h = (h * 0xC2B2AE35) & m
    h ^= h >> 16
    vals = set(h.tolist())
    if len(vals) != n or vals & set(RESERVED):
        raise ValueError("account hashes collide")
    return h


class Traffic:
    layout = "keyed"

    def __init__(self, params: dict, cfg: dict, seed: int, device):
        self.type_names = list(params["types"])
        self.pool_chunks = int(params["pool_chunks"])
        self.chunk = int(cfg["chunk"])
        self.n_keys = int(params["uids"])
        self.null_share = float(params["null_share"])
        self.events_per_feed = self.chunk
        g = torch.Generator(device=device)
        g.manual_seed(seed)
        shape = (self.pool_chunks, self.chunk)
        keys = torch.randint(0, self.n_keys, shape, generator=g,
                             device=device, dtype=torch.int32)
        null = torch.rand(shape, generator=g, device=device) < self.null_share
        #: (pool_chunks, chunk) int32 account index, -1 for a NULL key
        self.keys = keys.masked_fill_(null, -1)
        #: (pool_chunks, chunk) uint8 indices into ``type_names``
        self.types = torch.randint(0, len(self.type_names), shape,
                                   generator=g, device=device,
                                   dtype=torch.uint8)
        #: (n_keys,) int64 32-bit hash of each account
        self.key_hashes = account_hashes(self.n_keys).to(device)
        # events of each key in each pool chunk
        self.per_chunk = torch.zeros((self.pool_chunks, self.n_keys + 1),
                                     dtype=torch.int64, device=device)
        self.per_chunk.scatter_add_(
            1, (self.keys.long() + 1), torch.ones_like(self.keys,
                                                       dtype=torch.int64))
        self.per_chunk = self.per_chunk[:, 1:]

    def chunk_of(self, k: int) -> int:
        return k % self.pool_chunks

    def key_events_before(self, k: int) -> torch.Tensor:
        """(n_keys,) events of each key in feeds 0 .. k-1."""
        full, rem = divmod(k, self.pool_chunks)
        return (self.per_chunk.sum(0) * full
                + self.per_chunk[:rem].sum(0))

    def fill_feeds(self, window: int) -> int:
        """Feeds after which every key's window is full."""
        seen = torch.zeros(self.n_keys, dtype=torch.int64,
                           device=self.per_chunk.device)
        k = 0
        while int(seen.min()) < window + 1:
            seen += self.per_chunk[self.chunk_of(k)]
            k += 1
            if k > 64 * self.pool_chunks:
                raise ValueError("some key never fills its window")
        return k

    def history(self, k: int, window: int) -> int:
        """First feed of a block ending at feed ``k`` that holds at least
        ``window`` events of every key before feed ``k`` (or feed 0)."""
        seen = torch.zeros(self.n_keys, dtype=torch.int64,
                           device=self.per_chunk.device)
        j = k
        while j > 0 and int(seen.min()) < window:
            j -= 1
            seen += self.per_chunk[self.chunk_of(j)]
        return j
