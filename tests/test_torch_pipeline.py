"""The port's GPipe ``pipeline_apply`` (``repro_torch.distributed.pipeline``)
vs the sequential loop and vs the reference's (CPU).

L = 8 layers of ``tanh(h @ W[i])`` (D = 16), B = 8 rows, 4 stages over
``[cpu] * 4`` and 4 microbatches: the port's output equals the loop over
the layers within 1e-5, and equals the reference's ``pipeline_apply``
run under ``shard_map`` on 4 forced host devices (``subproc``) within
1e-5.  The same with a tree of stacked params (a weight and a bias),
with a ``ShardedTensor`` stage layout, and over 2 and 8 microbatches.
"""

import numpy as np
import pytest
import torch

from repro_torch.distributed.pipeline import pipeline_apply
from repro_torch.distributed.sharding import NamedSharding, P
from repro_torch.launch.mesh import make_host_mesh

L, B, D = 8, 8, 16
TOL = 1e-5


def weights():
    rng = np.random.RandomState(0)
    return (rng.randn(L, D, D) * 0.2).astype(np.float32), \
        rng.randn(B, D).astype(np.float32)


def block(w, h):
    return torch.tanh(h @ w)


def sequential(W, h):
    for i in range(W.shape[0]):
        h = block(W[i], h)
    return h


@pytest.fixture
def pods():
    return make_host_mesh((4,), ("pod",), devices=["cpu"] * 4)


@pytest.mark.parametrize("n_micro", [2, 4, 8])
def test_pipeline_matches_sequential(n_micro, pods):
    W, h0 = (torch.from_numpy(a) for a in weights())
    got = pipeline_apply(block, W, h0, mesh=pods, n_stages=4,
                         n_micro=n_micro, axis="pod")
    torch.testing.assert_close(got, sequential(W, h0), atol=TOL, rtol=0)


def test_pipeline_matches_reference(pods, subproc, tmp_path):
    W, h0 = weights()
    np.savez(tmp_path / "in.npz", W=W, h0=h0)
    subproc(f"""
import jax, jax.numpy as jnp, numpy as np
from repro.distributed.pipeline import pipeline_apply
d = np.load({str(tmp_path / 'in.npz')!r})
mesh = jax.make_mesh((4,), ('pod',))
got = pipeline_apply(lambda w, h: jnp.tanh(h @ w), jnp.asarray(d['W']),
                     jnp.asarray(d['h0']), mesh=mesh, n_stages=4,
                     n_micro=4, axis='pod')
np.save({str(tmp_path / 'ref.npy')!r}, np.asarray(got))
""", n_devices=4)
    want = np.load(tmp_path / "ref.npy")
    got = pipeline_apply(block, torch.from_numpy(W), torch.from_numpy(h0),
                         mesh=pods, n_stages=4, n_micro=4, axis="pod")
    np.testing.assert_allclose(got.numpy(), want, atol=TOL, rtol=0)


def test_pipeline_takes_a_param_tree_and_a_stage_layout(pods):
    W, h0 = (torch.from_numpy(a) for a in weights())
    b = torch.linspace(-0.5, 0.5, L * D).reshape(L, D)

    def biased(p, h):
        return torch.tanh(h @ p["w"] + p["b"])
    want = h0
    for i in range(L):
        want = biased({"w": W[i], "b": b[i]}, want)
    staged = {"w": NamedSharding(pods, P("pod")).place(W), "b": b}
    got = pipeline_apply(biased, staged, h0, mesh=pods, n_stages=4,
                         n_micro=4, axis="pod")
    torch.testing.assert_close(got, want, atol=TOL, rtol=0)


def test_pipeline_checks_its_stage_count(pods):
    W, h0 = (torch.from_numpy(a) for a in weights())
    with pytest.raises(ValueError, match="2 stages"):
        pipeline_apply(block, W, h0, mesh=pods, n_stages=2, n_micro=4)
