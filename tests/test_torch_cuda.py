"""The port's CUDA kernels vs their plain PyTorch versions, on a card.

Each test carries the ``cuda`` marker and skips where torch sees no CUDA
device; on a card (``python -m pytest -m cuda tests/test_torch_cuda.py``)
each kernel must give bit-identical output to its plain version — the
plain versions are held against the reference Pallas kernels on the CPU
by ``test_torch_kernels.py``.  This file imports nothing of JAX, so it
runs where only the port is installed.
"""

import zlib

import numpy as np
import pytest
import torch

from repro_torch import kernels
from repro_torch.kernels.mergejoin.mergejoin import (probe_sorted,
                                                     probe_sorted_plain)
from repro_torch.kernels.sortmerge.sortmerge import (bitonic_sort,
                                                     bitonic_sort_kv,
                                                     bitonic_sort_kv_plain,
                                                     bitonic_sort_plain,
                                                     merge_ranks,
                                                     merge_ranks_plain)


def rng(*salt):
    return np.random.RandomState(zlib.crc32(repr(salt).encode()))


def T(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def keys_with_extremes(r, n, dtype):
    info = np.iinfo(dtype)
    x = r.randint(-1000, 1000, n).astype(dtype)
    if n >= 4:
        x[r.choice(n, 3, replace=False)] = [info.max, info.min, info.max]
    return x


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the CUDA kernels have no CPU mode")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("n", [1, 7, 4096, 5000, 1 << 15])
@pytest.mark.parametrize("dtype", [torch.int32, torch.int64])
def test_cuda_bitonic_sort_equals_plain(cuda, n, dtype):
    x = T(keys_with_extremes(rng("csort", n), n,
                             np.int32 if dtype == torch.int32
                             else np.int64)).to(cuda)
    before = kernels.LAUNCHES["bitonic_sort"]
    got = bitonic_sort(x)
    torch.cuda.synchronize()
    assert torch.equal(got, bitonic_sort_plain(x))
    assert kernels.LAUNCHES["bitonic_sort"] == before + (n > 1)


@pytest.mark.cuda
@pytest.mark.parametrize("n", [2, 100, 4096, 9000, 1 << 15])
def test_cuda_bitonic_sort_kv_equals_plain(cuda, n):
    r = rng("ckv", n)
    k = T(r.randint(0, 50, n).astype(np.int64)).to(cuda)
    v = T(r.permutation(n).astype(np.int32)).to(cuda)
    gk, gv = bitonic_sort_kv(k, v)
    wk, wv = bitonic_sort_kv_plain(k, v)
    torch.cuda.synchronize()
    assert torch.equal(gk, wk) and torch.equal(gv, wv)


@pytest.mark.cuda
@pytest.mark.parametrize("n,m", [(1, 1), (1000, 37), (5000, 1 << 14)])
def test_cuda_probe_equals_plain(cuda, n, m):
    r = rng("cprobe", n, m)
    lk = T(r.randint(-5, 200, n).astype(np.int64)).to(cuda)
    rs = T(np.sort(r.randint(0, 190, m)).astype(np.int64)).to(cuda)
    lo, hi = probe_sorted(lk, rs)
    plo, phi = probe_sorted_plain(lk, rs)
    torch.cuda.synchronize()
    assert torch.equal(lo, plo) and torch.equal(hi, phi)


@pytest.mark.cuda
@pytest.mark.parametrize("side_right", [False, True], ids=["left", "right"])
@pytest.mark.parametrize("n,m", [(1, 1), (1000, 37), (5000, 1 << 14)])
def test_cuda_merge_ranks_equals_plain(cuda, n, m, side_right):
    r = rng("cranks", n, m)
    x = T(r.randint(-5, 200, n).astype(np.int64)).to(cuda)
    other = T(np.sort(r.randint(0, 190, m)).astype(np.int64)).to(cuda)
    before = kernels.LAUNCHES["merge_ranks"]
    got = merge_ranks(x, other, side_right=side_right)
    torch.cuda.synchronize()
    assert torch.equal(got, merge_ranks_plain(x, other, side_right))
    assert kernels.LAUNCHES["merge_ranks"] == before + 1


@pytest.mark.cuda
def test_cuda_wrappers_reject_bad_input(cuda):
    with pytest.raises(TypeError):
        bitonic_sort(torch.zeros(8, dtype=torch.float32, device=cuda))
    with pytest.raises(ValueError):
        probe_sorted(torch.zeros(8, dtype=torch.int64, device=cuda),
                     torch.zeros(8, dtype=torch.int64))


KG = [("Schema", "A", "subClassOf", "B"), ("Schema", "B", "subClassOf", "C"),
      ("Schema", "knows", "characteristic", "symmetric"),
      ("Schema", "partOf", "characteristic", "transitive"),
      ("Data", "x", "type", "A"), ("Data", "y", "type", "B"),
      ("Data", "x", "knows", "y"), ("Data", "p1", "partOf", "p2"),
      ("Data", "p2", "partOf", "p3"), ("Data", "p3", "partOf", "p4")]


@pytest.mark.cuda
@pytest.mark.parametrize("preset", ["infer1", "query1"])
def test_cuda_engine_equals_numpy(cuda, preset):
    """The engine on the ``torch`` backend launches the path's kernels and
    matches the ``numpy`` backend.  The facts go in two batches, so the
    AI index of ``query1`` merges the second into its sorted mirrors (an
    LPIM index re-sorts only after four 4096-row pages of appends)."""
    from repro_torch.core import EngineConfig, Fact, HiperfactEngine
    from repro_torch.core.conditions import cond
    from repro_torch.core.rulesets import rdfs_plus_rules
    from repro_torch.core.sharded import decoded_fact_checksum
    out = []
    for backend in ("torch", "numpy"):
        cfg = getattr(EngineConfig, preset)(backend=backend)
        cfg.eval_mode = "full"
        e = HiperfactEngine(cfg)
        e.add_rules(rdfs_plus_rules())
        kernels.reset_counts()
        e.insert_facts([Fact(*f) for f in KG[:6]])
        e.insert_facts([Fact(*f) for f in KG[6:]])
        s = e.infer()
        rows = {tuple(sorted(r.items()))
                for r in e.query([cond("Data", "?a", "partOf", "?b")])}
        if backend == "torch":
            skip = {"merge_ranks"} if preset == "infer1" else set()
            assert all(c > 0 for k, c in kernels.LAUNCHES.items()
                       if k not in skip)
        out.append((s.facts_inferred, rows, decoded_fact_checksum(e)))
    assert out[0] == out[1]
