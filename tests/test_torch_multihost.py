"""The port's several-host layer (`parallel.multihost`) with real
processes: 2 "hosts" x 2 ranks on the CPU (gloo), each rank joined through
`multihost.initialize` with 2 ranks per host, checking what
tests/multihost_worker.py checks for JAX: the global mesh keeps tp inside a
host (and a tp that would cross hosts raises), a sum over every rank across
hosts, the local <-> global round trip of the serving fan-out, one shard
per rank gathered in mesh order, a broadcast from rank 0 and a barrier."""

import pytest

from mast3r_slam_torch.parallel.mesh import spawn
from test_torch_parallel_workers import multihost_rank

HOSTS, WORLD = 2, 4


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    return spawn(multihost_rank, WORLD, (WORLD, HOSTS), join=False,
                 workdir=str(tmp_path_factory.mktemp("ranks")))


def test_global_mesh_keeps_tp_in_a_host(ranks):
    for r in ranks:
        assert r["mesh_shape"] == {"dp": 2, "tp": 2}
        assert r["tp_in_one_host"] and r["cross_host_tp_raises"]
    assert [r["tp_ranks"] for r in ranks] == [[0, 1], [0, 1], [2, 3], [2, 3]]


def test_cross_host_sum_fanout_broadcast(ranks):
    for r in ranks:
        assert r["psum"] == 10.0  # 1 + 2 + 3 + 4
        assert r["gathered"] == [1.0, 2.0, 3.0, 4.0]
        assert r["global_shape"] == [4, 4, 3] and r["fanout_ok"]
        assert r["broadcast"] == 3.0
        assert r["replicated"] == ["Replicate", "Replicate"]
