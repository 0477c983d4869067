"""Hand-written Hopper kernels of the port, and what counts their use.

Each kernel lives in ``csrc/`` (CUDA C++ for ``sm_90a``, built by
``_build.py``) with a wrapper module beside the reference package's
counterpart (``sortmerge/sortmerge.py``, ``mergejoin/mergejoin.py``,
``uniquefilter/uniquefilter.py``, ``flash_attention/flash_attention.py``,
``ssd/ssd.py``), and one kernel that replaces an XLA-compiled step of
the reference rather than a Pallas kernel: the RG-LRU linear scan
(``rglru_scan/scan.py``).  A wrapper given a CUDA tensor
launches its kernel or raises; given a CPU tensor it runs the kernel's
plain PyTorch version.

``LAUNCHES`` counts wrapper calls that launched a kernel (plain-version
calls on CPU tensors do not count); ``flash_attention`` counts both of
its routes, ``flash_attention_wgmma`` the tensor-core route alone.
``FALLBACKS`` counts the paths that bypass the kernels: the stock-torch
stable sorts taken when keys are too wide to tag (``stable_sort_perm``,
``dedup_rows``) and the exact host redo of a join whose keys collide
with a pad sentinel (``join_host_redo``).  ``SORT_SIZES`` counts the
sort kernels' launches by log2 of the padded length, ``SEARCH_SIZES``
those of ``probe_sorted`` by (log2 n, log2 m) and of
``unique_mask_sorted`` by log2 n, each rounded up.

A fake tensor (``launch.fake.is_fake``: the dry run's ``ShapeTensor``s,
or torch's ``FakeTensor``) takes a wrapper's fake path: the same checks
and output allocations as a launch, and no kernel; it computes nothing
and counts no launch.  Both a launch and a fake path announce the kernel
to an active ``launch.hlo_analysis.Recorder`` (``launched``), charged
the work its bound in ``PERF.md`` is computed from.
"""

from repro_torch.launch import hlo_analysis as _ha
from repro_torch.launch.fake import is_fake  # noqa: F401  (the wrappers')

LAUNCHES = {"bitonic_sort": 0, "bitonic_sort_kv": 0, "probe_sorted": 0,
            "merge_ranks": 0, "unique_mask_sorted": 0,
            "flash_attention": 0, "flash_attention_wgmma": 0,
            "ssd_intra": 0, "linear_scan": 0}
# the fact engine's kernels; the LM serving path's are the others
ENGINE_KERNELS = ("bitonic_sort", "bitonic_sort_kv", "probe_sorted",
                  "merge_ranks", "unique_mask_sorted")
FALLBACKS = {"stable_sort_perm": 0, "dedup_rows": 0, "join_host_redo": 0}
# launches of the two sort kernels by log2 of the padded length
SORT_SIZES: dict = {"bitonic_sort": {}, "bitonic_sort_kv": {}}
# launches of the probe by (log2 n, log2 m), of the unique mask by (log2 n,)
SEARCH_SIZES: dict = {"probe_sorted": {}, "unique_mask_sorted": {}}


def count_sort_size(name: str, n_pad: int) -> None:
    sizes = SORT_SIZES[name]
    lg = n_pad.bit_length() - 1
    sizes[lg] = sizes.get(lg, 0) + 1


def count_search_size(name: str, *lengths: int) -> None:
    sizes = SEARCH_SIZES[name]
    key = tuple(max(n - 1, 0).bit_length() for n in lengths)
    sizes[key] = sizes.get(key, 0) + 1


def launched(names, device, work, real: bool = True) -> None:
    """One call of a kernel: ``names`` (its ``LAUNCHES`` keys, the first
    its own) counted when ``real``, and announced to an active recorder
    with ``work()`` -> (operations, bytes)."""
    if real:
        for n in names:
            LAUNCHES[n] += 1
    rec = _ha.ACTIVE
    if rec is not None:
        ops, nbytes = work()
        rec.kernel(names, device, ops, nbytes)


def reset_counts() -> None:
    for d in (LAUNCHES, FALLBACKS):
        for k in d:
            d[k] = 0
    for sizes in (*SORT_SIZES.values(), *SEARCH_SIZES.values()):
        sizes.clear()


def counts() -> dict:
    """A snapshot of the counters."""
    return {"launches": dict(LAUNCHES), "fallbacks": dict(FALLBACKS),
            "sort_sizes": {k: dict(sorted(v.items()))
                           for k, v in SORT_SIZES.items()},
            "search_sizes": {k: {",".join(map(str, lg)): c
                                 for lg, c in sorted(v.items())}
                             for k, v in SEARCH_SIZES.items()}}
