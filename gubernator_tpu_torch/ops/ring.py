"""Ring all-reduce-sum over S shards: plain PyTorch version and CUDA kernel.

The counterpart of the JAX package's ops/ring.py, whose Pallas kernel
(`_ring_kernel`) sums one int64 vector per device around a 1-D ring of
chips in N-1 rotate-and-accumulate hops. Here the S shards of the GLOBAL
sync (parallel/global_sync.py) are S rows of one tensor on one device,
int64[S, L], and every output row is the sum of all rows:

- ring_all_reduce_plain() does the same S-1 hops with torch.roll;
- csrc/ring.cu does them in registers, one column per thread in blocks of
  64, through the shared launch path (ops/_launch.py).

ring_all_reduce() takes a tensor on either device: on the CPU it runs the
plain version, on CUDA it launches the kernel, or raises.

The cross-card form is the Pallas kernel as it runs on each device of a
mesh axis: one int64[L] tensor a mesh entry, each on its entry's device.
ring_all_reduce_mesh() returns the n sums, each on its own device:

- ring_all_reduce_mesh_plain() does the same n-1 hops with torch ops,
  each entry adding what its left-hand neighbour forwarded;
- csrc/ring.cu ring_mesh_launch makes it ONE launch a card: the entries
  are grouped by card, and each card's kernel sums every entry's column in
  one pass (local pointers for the card's own entries, peer pointers over
  NVLink for the other cards') into the card's own entries' outputs.
  Events order the entry streams of a card; across cards the launches wait
  for each other through flags in peer memory (a fresh epoch a call).

Every entry has its own stream (entry_streams), also where entries share a
card: a card's launch goes on its first entry's stream, which waits for
the card's other entries first, and they wait for it after.
"""

from __future__ import annotations

import ctypes
from types import SimpleNamespace
from typing import Dict, List, Optional, Sequence, Set, Tuple

import torch

from gubernator_tpu_torch.ops import _launch

I64 = torch.int64

# Launches of the CUDA kernel: the wrapper adds one where it launches.
launch_counts: Dict[str, int] = {"ring_all_reduce": 0, "ring_all_reduce_mesh": 0}


def reset_launch_counts() -> None:
    for k in launch_counts:
        launch_counts[k] = 0


def ring_all_reduce_plain(x: torch.Tensor) -> torch.Tensor:
    """int64[S, L] -> int64[S, L], every row the (wrapping) sum of all rows,
    built as the Pallas kernel builds it: S-1 hops, each shard adding the
    value its left-hand neighbour forwarded on the previous hop."""
    acc = x.clone()
    comm = x
    for _ in range(x.shape[0] - 1):
        comm = torch.roll(comm, 1, 0)  # shard s receives from shard s-1
        acc += comm
    return acc


_kernels: Optional[SimpleNamespace] = None


def _load() -> SimpleNamespace:
    global _kernels
    if _kernels is None:
        V, I = _launch.VOID_P, _launch.INT
        P, IP = ctypes.POINTER(V), ctypes.POINTER(I)
        k = _launch.load("ring", {"ring_all_reduce_launch": (I, V, V, I, I, V),
                                  "ring_mesh_launch": (I, P, P, P, I, IP, IP, P, I,
                                                       ctypes.POINTER(ctypes.c_uint64)),
                                  "ring_can_access_peer": (I, I, IP),
                                  "ring_enable_peer": (I, I)})
        k.max_shards = k.lib.ring_max_shards()
        k.max_mesh_entries = k.lib.ring_mesh_max_entries()
        k.flag_words = k.lib.ring_mesh_flag_words()
        _kernels = k
    return _kernels


def ring_all_reduce_cuda(x: torch.Tensor) -> torch.Tensor:
    """Launch csrc/ring.cu on x's card. Raises
    on a tensor it does not take (not int64[S, L], not contiguous, S past
    the kernel's largest ring) or a refused launch."""
    index = _launch.cuda_index(x, "ring_all_reduce_cuda")
    _launch.check(x, "x", I64, (None, None), index)
    S, L = x.shape
    k = _kernels or _load()
    if S > k.max_shards:
        raise ValueError(f"the ring kernel takes at most {k.max_shards} shards, got {S}")
    out = torch.empty_like(x)
    if S == 0 or L == 0:
        return out
    _launch.raise_on(k.ring_all_reduce_launch(index, x.data_ptr(), out.data_ptr(), S, L,
                                              k.stream(index)), "ring")
    launch_counts["ring_all_reduce"] += 1
    return out


def ring_all_reduce(x: torch.Tensor) -> torch.Tensor:
    """The CPU takes the plain version; CUDA takes the kernel, or raises."""
    if x.is_cpu:
        return ring_all_reduce_plain(x)
    return ring_all_reduce_cuda(x)


# ------------------------------------------------------- the cross-card form

def ring_all_reduce_mesh_plain(xs: Sequence[torch.Tensor]) -> List[torch.Tensor]:
    """n int64[L] tensors, one a mesh entry on its own device -> n tensors,
    each the (wrapping) sum of all, on its entry's device. Built as the
    Pallas kernel builds it on each device: n-1 hops, each entry adding the
    value its left-hand neighbour forwarded on the previous hop."""
    n = len(xs)
    acc = [x.clone() for x in xs]
    comm = list(xs)
    for _ in range(n - 1):
        comm = [comm[(d - 1) % n].to(xs[d].device) for d in range(n)]
        for d in range(n):
            acc[d] += comm[d]
    return acc


# One stream a mesh entry, by the entries' card indices: every caller with
# the same cards in the same order (the engine, its GLOBAL step, a direct
# call) uses the same streams.
_streams: Dict[Tuple[int, ...], Tuple[torch.cuda.Stream, ...]] = {}
_peers: Set[Tuple[int, int]] = set()  # (card, peer) pairs with access enabled


def entry_streams(indices: Sequence[int]) -> Tuple[torch.cuda.Stream, ...]:
    """A stream of its own for each mesh entry on card indices[d], made at
    first use and kept."""
    key = tuple(int(i) for i in indices)
    got = _streams.get(key)
    if got is None:
        # setdefault: of two threads making the first streams for the same
        # cards, both keep the one that was stored first
        got = _streams.setdefault(key, tuple(torch.cuda.Stream(device=i) for i in key))
    return got


def group_by_card(indices: Sequence[int]) -> Tuple[Tuple[int, ...], Tuple[Tuple[int, ...], ...]]:
    """The cards of the entries on card indices[d], in order of first
    appearance, and each card's entry positions in entry order."""
    cards: List[int] = []
    entries: List[List[int]] = []
    for d, i in enumerate(indices):
        if i not in cards:
            cards.append(i)
            entries.append([])
        entries[cards.index(i)].append(d)
    return tuple(cards), tuple(tuple(e) for e in entries)


class CardSet:
    """What an all-reduce over one card set (the entries' card indices, the
    key of entry_streams) keeps between calls: the entries' streams, the
    grouping by card, the stream each card's launch goes on (its first
    entry's), the arguments of the entry point that never change, and, over
    two cards or more, one zeroed flag buffer a card with the epoch counter
    the entry point increments."""

    def __init__(self, key: Tuple[int, ...], streams, flag_words: int):
        self.streams = streams
        self.cards, self.entries = group_by_card(key)
        self.launch = tuple(streams[e[0]] for e in self.entries)
        self.flags = ([_new_flags(c, st, flag_words) for c, st in zip(self.cards, self.launch)]
                      if len(self.cards) > 1 else [])
        n, c = len(key), len(self.cards)
        self.args = ((ctypes.c_void_p * n)(*(s.cuda_stream for s in streams)), c,
                     (ctypes.c_int * c)(*self.cards),
                     (ctypes.c_int * n)(*(self.cards.index(i) for i in key)),
                     (ctypes.c_void_p * c)(*(f.data_ptr() for f in self.flags))
                     if self.flags else None)
        self.epoch = ctypes.c_uint64(0)


def _new_flags(card: int, stream, words: int) -> torch.Tensor:
    """A card's flag buffer, u64[words] as int64, zeroed before any kernel
    can read it (its zeros are written on the card's launch stream, and a
    peer reads the buffer before this card's first launch, so the card is
    synchronised once here)."""
    with torch.cuda.stream(stream):
        f = torch.zeros(words, dtype=I64, device=torch.device("cuda", card))
    torch.cuda.synchronize(card)
    return f


# One CardSet a card set, made at first use and kept (the flag buffers are
# read by every later call's kernels).
_sets: Dict[Tuple[int, ...], CardSet] = {}


def card_set(k: SimpleNamespace, key: Tuple[int, ...]) -> CardSet:
    """The card set of the entries on cards `key`. Raises where its streams
    are no longer entry_streams(key): its flags' epochs hold only in the
    launch order of one stream a card."""
    streams = entry_streams(key)
    got = _sets.get(key)
    if got is None:
        got = _sets.setdefault(key, CardSet(key, streams, k.flag_words))
    if got.streams is not streams:
        raise ValueError(f"the all-reduce over cards {list(key)} runs on other streams than its "
                         "card set's own (entry_streams)")
    return got


def _enable_peers(k: SimpleNamespace, cards: Sequence[int]) -> None:
    """Peer access for every ordered pair of distinct cards of the set, once
    a pair: each card reads every other card's inputs and flags. Raises,
    naming both cards, where one cannot read the other's memory: there is
    no copy through the host to fall back on."""
    for a in cards:
        for b in cards:
            if a == b or (a, b) in _peers:
                continue
            can = ctypes.c_int(0)
            _launch.raise_on(k.ring_can_access_peer(a, b, ctypes.byref(can)), "ring peer query")
            if not can.value:
                raise RuntimeError(f"cuda:{a} cannot read cuda:{b}'s memory (no peer access): "
                                   "the cross-card all-reduce needs every pair of its cards "
                                   "peer-mapped")
            _launch.raise_on(k.ring_enable_peer(a, b), f"ring peer access cuda:{a} -> cuda:{b}")
            _peers.add((a, b))


def mesh_call(xs: Sequence[torch.Tensor]):
    """The checks and operands of one cross-card all-reduce over n >= 2
    entries: (library, card set, outputs, the entry point's arguments), the
    outputs allocated on the entries' streams. ring_all_reduce_mesh_cuda
    passes the arguments to k.ring_mesh_launch; chip_smoke.py times that
    call alone with them."""
    n = len(xs)
    key = tuple(_launch.cuda_index(x, "ring_all_reduce_mesh_cuda") for x in xs)
    L = xs[0].shape[0] if xs[0].dim() == 1 else -1
    for d, x in enumerate(xs):
        _launch.check(x, f"xs[{d}]", I64, (L if L >= 0 else None,), key[d])
    k = _kernels or _load()
    if n > k.max_mesh_entries:
        raise ValueError(f"the cross-card all-reduce takes at most {k.max_mesh_entries} "
                         f"entries, got {n}")
    cs = card_set(k, key)
    _enable_peers(k, cs.cards)
    outs = []
    for x, st in zip(xs, cs.streams):
        with torch.cuda.stream(st):
            outs.append(torch.empty_like(x))
    P = ctypes.c_void_p * n
    streams, c, devices, card_of, flags = cs.args
    args = (n, P(*(x.data_ptr() for x in xs)), P(*(o.data_ptr() for o in outs)), streams, c,
            devices, card_of, flags, L, ctypes.byref(cs.epoch))
    return k, cs, outs, args


def ring_all_reduce_mesh_cuda(xs: Sequence[torch.Tensor]) -> List[torch.Tensor]:
    """Launch csrc/ring.cu's cross-card all-reduce over the entries xs
    (int64[L] each, on its entry's card, at most 64): one launch a card, on
    the entry_streams stream of the card's first entry, summing every
    entry's column in one pass (csrc/ring.cu says how). xs[d] must be ready
    on entry d's stream; each sum is allocated on, and ready on, that
    stream; the inputs are left untouched.

    Over two cards or more the cards' launches wait for each other through
    flags in peer memory, so each card's stream must reach its launch: no
    entry stream may wait on work that another entry queues after this
    call. Raises on a tensor it does not take, a pair of cards without peer
    access, streams that are not the card set's own, or a refused launch;
    there is no fallback."""
    n = len(xs)
    if n == 0:
        raise ValueError("ring_all_reduce_mesh_cuda needs at least one entry")
    if n == 1:
        index = _launch.cuda_index(xs[0], "ring_all_reduce_mesh_cuda")
        _launch.check(xs[0], "xs[0]", I64, (None,), index)
        with torch.cuda.stream(entry_streams([index])[0]):
            return [xs[0].clone()]
    k, cs, outs, args = mesh_call(xs)
    _launch.raise_on(k.ring_mesh_launch(*args), "ring_mesh")
    if xs[0].numel():
        launch_counts["ring_all_reduce_mesh"] += len(cs.cards)
    return outs


def ring_all_reduce_mesh(xs: Sequence[torch.Tensor]) -> List[torch.Tensor]:
    """The sums of the mesh entries' int64[L] tensors, each on its entry's
    device. Entries on the CPU take the plain version; entries on cards
    take the kernel, or raise."""
    if all(x.is_cpu for x in xs):
        return ring_all_reduce_mesh_plain(xs)
    return ring_all_reduce_mesh_cuda(xs)
