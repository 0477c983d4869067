"""Hand-written Hopper kernels of the port, and what counts their use.

Each kernel lives in ``csrc/`` (CUDA C++ for ``sm_90a``, built by
``_build.py``) with a wrapper module beside the reference package's
counterpart (``sortmerge/sortmerge.py``, ``mergejoin/mergejoin.py``).  A
wrapper given a CUDA tensor launches its kernel or raises; given a CPU
tensor it runs the kernel's plain PyTorch version.

``LAUNCHES`` counts wrapper calls that launched a kernel (plain-version
calls on CPU tensors do not count).  ``FALLBACKS`` counts the paths that
bypass the kernels: the stock-torch stable sorts taken when keys are too
wide to tag (``stable_sort_perm``, ``dedup_rows``) and the exact host
redo of a join whose keys collide with a pad sentinel
(``join_host_redo``).
"""

LAUNCHES = {"bitonic_sort": 0, "bitonic_sort_kv": 0, "probe_sorted": 0,
            "merge_ranks": 0}
FALLBACKS = {"stable_sort_perm": 0, "dedup_rows": 0, "join_host_redo": 0}


def reset_counts() -> None:
    for d in (LAUNCHES, FALLBACKS):
        for k in d:
            d[k] = 0


def counts() -> dict:
    """A snapshot of both counters."""
    return {"launches": dict(LAUNCHES), "fallbacks": dict(FALLBACKS)}
