"""Fork-join bitonic sort: CUDA kernel wrappers and plain versions.

Port of the reference ``kernels/sortmerge/sortmerge.py`` ``bitonic_sort``
and ``bitonic_sort_kv`` (paper §2.3, Fig. 8).  The network is the same:
the array is padded to a power of two with the dtype's maximum, element
``i`` exchanges with ``i ^ j`` for every ``(k, j)`` pass, ascending iff
``i & k == 0``, and a pair swaps only on a strict order violation.  So the
CUDA kernel (``csrc/bitonic_sort.cu``), the plain versions below and the
Pallas kernel give bit-identical output, the key-value payload and the
order of tied keys included.

``merge_ranks`` is the port of the reference's two-run merge rank kernel
(``csrc/merge_ranks.cu``): the rank of every element of ``x`` in a
second sorted run, the core of the incremental index-mirror merge.  It
searches the probe's shared-memory splitter tree
(``mergejoin.merge_ranks_plan`` gives its size, by which the wrapper
allocates the tree's scratch).

A wrapper given a CUDA tensor launches the kernel or raises; a CPU tensor
takes the plain version — vectorised XOR-partner compare-exchanges over
the whole array, one pass per ``(k, j)``, and for the ranks the Pallas
kernel's branch-free search, ``log2(m) + 1`` masked halving steps.
"""

from __future__ import annotations

import torch

from repro_torch import kernels
from repro_torch.kernels import _build


def _pad_pow2(x: torch.Tensor, fill) -> torch.Tensor:
    """A new buffer of the next power of two: ``x``, then ``fill``.  The
    input is copied once and only the tail is filled."""
    n = x.shape[0]
    n_pad = 1 << max(n - 1, 0).bit_length()
    out = torch.empty((n_pad,), dtype=x.dtype, device=x.device)
    out[:n] = x
    if n_pad > n:
        out[n:].fill_(fill)
    return out


def _passes(n_pad: int):
    k = 2
    while k <= n_pad:
        j = k // 2
        while j >= 1:
            yield k, j
            j //= 2
        k *= 2


# How the CUDA kernel groups the network (the constants at the head of
# csrc/bitonic_sort.cu): the tile and register width of the keys-only and
# of the key-value sort on large arrays (the top tier), the smaller tiers,
# the tiles an array must hold to take a tier, and the cross-tile levels
# fused per launch
SORT_TILE, SORT_REG = 1 << 14, 32
SORT_KV_TILE, SORT_KV_REG = 1 << 13, 16
SORT_LOWER_TIERS = ((1 << 13, 16), (1 << 12, 16), (1 << 10, 8))
SORT_MIN_TILES = 128
SORT_FUSE = 4  # cross-tile levels fused in registers, at most
# cross-tile levels of one launch, at most, once the array holds
# SORT_MIN_TILES shared-memory blocks of _CROSS_BLOCK elements (cross_smem:
# _XS_THREADS threads of 2**_XS_REG_LOG2 elements)
SORT_CROSS_LEVELS = 9
_XS_THREADS, _XS_REG_LOG2 = 512, 4
_CROSS_BLOCK = _XS_THREADS << _XS_REG_LOG2
_SMEM_LEVELS = 4  # shared-memory levels per barrier, at most


def sort_tier(n_pad: int, kv: bool = False) -> tuple[int, int]:
    """(tile, register width) the kernel takes for a padded length: the top
    tier when ``n_pad`` holds ``SORT_MIN_TILES`` of its tiles, else the
    first smaller tier it fills as well, else the last."""
    top = (SORT_KV_TILE, SORT_KV_REG) if kv else (SORT_TILE, SORT_REG)
    if n_pad >= SORT_MIN_TILES * top[0]:
        return top
    for tile, reg in SORT_LOWER_TIERS[:-1]:
        if tile < top[0] and n_pad >= SORT_MIN_TILES * tile:
            return tile, reg
    return SORT_LOWER_TIERS[-1]


def launch_plan(n_pad: int, tile: int | None = None,
                reg_width: int | None = None, fuse: int | None = None,
                kv: bool = False, cross_levels: int | None = None) -> list:
    """The CUDA kernel's launches for a padded length ``n_pad``, in order
    (by default on the tier ``sort_tier(n_pad, kv)`` picks):
    ``(kind, steps)`` with kind ``"tile"`` (one shared-memory tile per
    block) or ``"cross"`` (fused levels through device memory), and each
    step ``(where, levels)``: the ``(k, j)`` passes that one unit of the
    kernel applies together, ``where`` being ``"cross"`` or ``"smem"`` (a
    sub-network of ``2**len(levels)`` elements per thread, loaded once and
    stored once), ``"shuffle"`` (warp levels) or ``"register"``.  A cross
    launch runs up to ``cross_levels`` levels (by default
    ``SORT_CROSS_LEVELS`` when the array holds ``SORT_MIN_TILES`` blocks
    of ``_CROSS_BLOCK`` elements, else ``fuse``, by default ``SORT_FUSE``):
    up to ``fuse`` of them as one register sub-network, more as
    shared-memory groups of up to ``_SMEM_LEVELS`` over a block of rows.
    Flattened, the levels are ``_passes(n_pad)``."""
    if tile is None:
        tile, reg_width = sort_tier(n_pad, kv)
    if fuse is None:
        fuse = SORT_FUSE
    if cross_levels is None:
        cross_levels = (SORT_CROSS_LEVELS
                        if n_pad >= SORT_MIN_TILES * _CROSS_BLOCK else fuse)
    launches = []
    if n_pad < 2:
        return launches
    launches.append(("tile", _tile_steps(2, min(n_pad, tile), tile,
                                         reg_width)))
    k = 2 * tile
    while k <= n_pad:
        j = k // 2
        while j >= tile:
            r = min(cross_levels, (j // tile).bit_length())
            levels = [(k, j >> m) for m in range(r)]
            group = min(_XS_REG_LOG2, _SMEM_LEVELS)
            launches.append(("cross", [("cross", levels)] if r <= fuse else [
                ("smem", levels[i:i + group]) for i in range(0, r, group)]))
            j >>= r
        launches.append(("tile", _tile_steps(k, k, tile, reg_width)))
        k *= 2
    return launches


def _tile_steps(k_lo: int, k_hi: int, tile: int, reg_width: int) -> list:
    """Steps of one tile launch: stages ``k_lo .. k_hi``, each from
    ``j = min(k, tile) / 2`` down: shared-memory groups of up to
    ``min(log2(reg_width), _SMEM_LEVELS)`` levels while
    ``j >= 32 * reg_width``, then the warp levels, then the register
    levels ``j < reg_width``."""
    span = 32 * reg_width
    e_log2 = min(reg_width.bit_length() - 1, _SMEM_LEVELS)
    steps = []
    k = k_lo
    while k <= k_hi:
        j = min(k, tile) // 2
        while j >= span:
            r = min(e_log2, (j // span).bit_length())
            steps.append(("smem", [(k, j >> m) for m in range(r)]))
            j >>= r
        for where, low in (("shuffle", reg_width), ("register", 1)):
            levels = []
            while j >= low:
                levels.append((k, j))
                j //= 2
            if levels:
                steps.append((where, levels))
        k *= 2
    return steps


def bitonic_sort_plain(x: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch version of the network (any device)."""
    n = x.shape[0]
    if n <= 1:
        return x.clone()
    xp = _pad_pow2(x, torch.iinfo(x.dtype).max)
    idx = torch.arange(xp.shape[0], device=x.device)
    for k, j in _passes(xp.shape[0]):
        px = xp[idx ^ j]
        # the lower lane of an ascending pair (and the upper lane of a
        # descending one) keeps the minimum
        take_min = ((idx & j) == 0) == ((idx & k) == 0)
        xp = torch.where(take_min, torch.minimum(xp, px),
                         torch.maximum(xp, px))
    return xp[:n]


def bitonic_sort_kv_plain(keys: torch.Tensor, vals: torch.Tensor
                          ) -> tuple[torch.Tensor, torch.Tensor]:
    """Plain PyTorch version of the key-value network (any device)."""
    n = keys.shape[0]
    if n <= 1:
        return keys.clone(), vals.clone()
    kp = _pad_pow2(keys, torch.iinfo(keys.dtype).max)
    vp = _pad_pow2(vals, 0)
    idx = torch.arange(kp.shape[0], device=keys.device)
    for k, j in _passes(kp.shape[0]):
        part = idx ^ j
        pk, pv = kp[part], vp[part]
        is_lo = (idx & j) == 0
        a = torch.where(is_lo, kp, pk)  # lower lane's key
        b = torch.where(is_lo, pk, kp)  # upper lane's key
        # both lanes of a pair see the same (a, b), so they agree on the swap
        swap = torch.where((idx & k) == 0, a > b, a < b)
        kp = torch.where(swap, pk, kp)
        vp = torch.where(swap, pv, vp)
    return kp[:n], vp[:n]


def merge_ranks_plain(x: torch.Tensor, other_sorted: torch.Tensor,
                      side_right: bool = False) -> torch.Tensor:
    """Plain PyTorch version of the rank search (any device): int32
    ``searchsorted(other_sorted, x, side)``."""
    n, m = x.shape[0], other_sorted.shape[0]
    lo = torch.zeros(n, dtype=torch.int64, device=x.device)
    if m == 0:
        return lo.to(torch.int32)
    hi = torch.full((n,), m, dtype=torch.int64, device=x.device)
    for _ in range(max(1, (m - 1).bit_length()) + 1):
        active = lo < hi
        mid = (lo + hi) // 2
        v = other_sorted[mid.clamp(0, m - 1)]
        go = (v <= x) if side_right else (v < x)
        lo = torch.where(active & go, mid + 1, lo)
        hi = torch.where(active & ~go, mid, hi)
    return lo.to(torch.int32)


def _check_cuda(name: str, t: torch.Tensor, dtypes) -> None:
    if t.dtype not in dtypes:
        raise TypeError(f"{name}: dtype {t.dtype} not in {dtypes}")
    if t.dim() != 1 or not t.is_contiguous():
        raise ValueError(f"{name}: expects a contiguous 1-D tensor")


def _launched(name: str, xp: torch.Tensor, lane_bytes: int,
              real: bool = True) -> None:
    """A sort of the padded ``xp``: operations, the network's
    compare-exchanges (``n/2`` in each of its ``lg(lg+1)/2`` passes);
    bytes, each lane (``lane_bytes``, keys and payload) read and written
    once."""
    def work():
        n = xp.shape[0]
        lg = max(1, (n - 1).bit_length())
        return (n // 2 * lg * (lg + 1) // 2, 2 * lane_bytes * n)
    kernels.launched((name,), xp.device, work, real)


def bitonic_sort(x: torch.Tensor) -> torch.Tensor:
    """Sort a 1-D int32/int64 tensor ascending.  The CUDA kernel groups the
    network's levels into tiles, warps, registers and fused launches
    (``launch_plan``) and computes the same function as the plain version;
    a tensor it does not take raises, and nothing falls back."""
    fake = kernels.is_fake(x)
    if x.device.type == "cpu" and not fake:
        return bitonic_sort_plain(x)
    if x.device.type != "cuda" and not fake:
        raise ValueError(f"bitonic_sort: unsupported device {x.device}")
    _check_cuda("bitonic_sort", x, (torch.int64, torch.int32))
    n = x.shape[0]
    if n <= 1:
        return x.clone()
    xp = _pad_pow2(x, torch.iinfo(x.dtype).max)
    if fake:
        _launched("bitonic_sort", xp, x.element_size(), real=False)
        return xp[:n]
    lib = _build.library("bitonic_sort")
    fn = (lib.bitonic_sort_i64 if x.dtype == torch.int64
          else lib.bitonic_sort_i32)
    _build.check(fn(xp.data_ptr(), xp.shape[0],
                    torch.cuda.current_stream(x.device).cuda_stream),
                 "bitonic_sort")
    _launched("bitonic_sort", xp, x.element_size())
    kernels.count_sort_size("bitonic_sort", xp.shape[0])
    return xp[:n]


def bitonic_sort_kv(keys: torch.Tensor, vals: torch.Tensor
                    ) -> tuple[torch.Tensor, torch.Tensor]:
    """Key-value sort: int64 keys carrying an int32 payload (unstable).
    The CUDA kernel runs the plain version's compare-exchanges in the same
    order, regrouped as ``launch_plan(n, kv=True)`` says, so the payload
    order of tied keys is the plain version's too."""
    fake = kernels.is_fake(keys) or kernels.is_fake(vals)
    if keys.device.type == "cpu" and vals.device.type == "cpu" \
            and not fake:
        return bitonic_sort_kv_plain(keys, vals)
    if (keys.device.type != "cuda" and not fake) \
            or vals.device != keys.device:
        raise ValueError("bitonic_sort_kv: keys and vals must share one "
                         f"CUDA device, got {keys.device} and {vals.device}")
    _check_cuda("bitonic_sort_kv", keys, (torch.int64,))
    _check_cuda("bitonic_sort_kv", vals, (torch.int32,))
    n = keys.shape[0]
    if vals.shape[0] != n:
        raise ValueError("bitonic_sort_kv: keys and vals differ in length")
    if n <= 1:
        return keys.clone(), vals.clone()
    kp = _pad_pow2(keys, torch.iinfo(torch.int64).max)
    vp = _pad_pow2(vals, 0)
    if fake:
        _launched("bitonic_sort_kv", kp, 12, real=False)
        return kp[:n], vp[:n]
    lib = _build.library("bitonic_sort")
    _build.check(lib.bitonic_sort_kv_i64(
        kp.data_ptr(), vp.data_ptr(), kp.shape[0],
        torch.cuda.current_stream(keys.device).cuda_stream),
        "bitonic_sort_kv")
    _launched("bitonic_sort_kv", kp, 12)
    kernels.count_sort_size("bitonic_sort_kv", kp.shape[0])
    return kp[:n], vp[:n]


def merge_ranks(x: torch.Tensor, other_sorted: torch.Tensor,
                side_right: bool = False) -> torch.Tensor:
    """Rank of every ``x`` element inside the sorted run ``other_sorted``
    (``searchsorted`` semantics: ``side_right=False`` counts strictly
    smaller elements, ``True`` counts <=), as int32.  Pad tails are the
    caller's business, as in the reference: they must sort above every
    real key, and the caller bounds the ranks by the run's real length."""
    fake = kernels.is_fake(x) or kernels.is_fake(other_sorted)
    if x.device.type == "cpu" and other_sorted.device.type == "cpu" \
            and not fake:
        return merge_ranks_plain(x, other_sorted, side_right)
    if (x.device.type != "cuda" and not fake) \
            or other_sorted.device != x.device:
        raise ValueError("merge_ranks: both runs must share one CUDA "
                         f"device, got {x.device} and {other_sorted.device}")
    _check_cuda("merge_ranks", x, (torch.int64,))
    _check_cuda("merge_ranks", other_sorted, (torch.int64,))
    n, m = x.shape[0], other_sorted.shape[0]
    if m >= 1 << 31:
        raise ValueError("merge_ranks: int32 ranks need m < 2**31")
    ranks = torch.empty(n, dtype=torch.int32, device=x.device)
    if n == 0:
        return ranks
    # scratch for the tree (2^ceil(log2 table) slots) when it is not the
    # whole other run and many keys share it
    from repro_torch.kernels.mergejoin import mergejoin
    s, table = mergejoin.merge_ranks_plan(n, m)
    gather = s and n > 1 << mergejoin.RANK_SMALL_N_LOG2
    tree = torch.empty(1 << max(table - 1, 0).bit_length() if gather else 0,
                       dtype=torch.int64, device=x.device)

    def work():
        # bytes: both runs read once, the ranks written once; operations:
        # one binary search of the other run per element
        return (n * max(1, (m - 1).bit_length()), 12 * n + 8 * m)
    if fake:
        kernels.launched(("merge_ranks",), x.device, work, real=False)
        return ranks
    lib = _build.library("merge_ranks")
    _build.check(lib.merge_ranks_i64(
        x.data_ptr(), n, other_sorted.data_ptr(), m, int(side_right),
        ranks.data_ptr(), tree.data_ptr(), tree.shape[0],
        torch.cuda.current_stream(x.device).cuda_stream), "merge_ranks")
    kernels.launched(("merge_ranks",), x.device, work)
    return ranks
