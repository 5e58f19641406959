"""``DecentralizedTrainer.w``: the current schedule period's dense W, as the
reference's trainer keeps it. On an ``@rewire`` schedule it is held to the
reference's ``np.asarray(tr.w)`` at construction and after every round (so
after each period change), through the port's ``run`` and ``run_fused``."""

import numpy as np
import pytest
import torch

from repro.core import partition as ref_partition
from repro.core import topology as ref_topology
from repro.data import loader as ref_loader
from repro.data.synthetic import make_mnist_like
from repro.models.mlp import init_mlp
from repro.train.trainer import DecentralizedTrainer as RefTrainer
from repro_torch.data.loader import NodeLoader
from repro_torch.train.trainer import DecentralizedTrainer

N, BATCH, DIM, HIDDEN, ROUNDS = 10, 8, 32, (16,), 7
REWIRE = "er:n=10,p=0.5@rewire=2"


@pytest.fixture(scope="module")
def data():
    ds = make_mnist_like(train_per_class=40, test_per_class=10, dim=DIM, seed=0)
    return ds, ref_partition.hub_focused(ds.y_train, _graph(), seed=1)


def _graph():
    return ref_topology.make_schedule(REWIRE, seed=0).graph_at(0)


def _np(w):
    return w.cpu().numpy() if isinstance(w, torch.Tensor) else np.asarray(w)


def _ws(tr, run, ds):
    """W at construction, then after each round's evaluation."""
    ws = [_np(tr.w)]
    run(ROUNDS, eval_every=1, x_test=ds.x_test, y_test=ds.y_test,
        on_round=lambda m: ws.append(_np(tr.w)))
    return ws


@pytest.fixture(scope="module", params=[1, 3], ids=lambda k: f"every{k}")
def ref_ws(request, data):
    ds, parts = data
    ld = ref_loader.NodeLoader(ds.x_train, ds.y_train, parts, batch_size=BATCH, seed=2)
    tr = RefTrainer(REWIRE, ld, gossip_every=request.param, seed=0, in_dim=DIM,
                    init_fn=lambda k: init_mlp(k, in_dim=DIM, hidden=HIDDEN))
    return request.param, _ws(tr, tr.run, ds)


@pytest.mark.parametrize("backend", ["dense", "sparse"])
@pytest.mark.parametrize("fused", [False, True], ids=["run", "run_fused"])
def test_w_follows_the_reference_across_periods(data, ref_ws, backend, fused):
    ds, parts = data
    every, want = ref_ws
    loader = NodeLoader(ds.x_train, ds.y_train, parts, batch_size=BATCH, seed=2, device="cpu")
    tr = DecentralizedTrainer(REWIRE, loader, mix_impl=backend, gossip_every=every, seed=0,
                              in_dim=DIM, hidden=HIDDEN, device="cpu")
    got = _ws(tr, tr.run_fused if fused else tr.run, ds)
    assert len(got) == len(want) == ROUNDS + 1
    assert len({w.tobytes() for w in want}) > 1  # the schedule did rewire
    for r, (g, w) in enumerate(zip(got, want)):
        np.testing.assert_allclose(g, w, rtol=0, atol=1e-7, err_msg=f"after round {r - 1}")
