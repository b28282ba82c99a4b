"""The port's collectives (sm3x_torch.parallel), its mesh record
(sm3x_torch.core.mesh) and its global-batch BatchNorm, on the CPU.

One launch of two gloo processes (this file run as a script, with
torchrun's environment from `sm3x_torch.parallel.launch`) makes every
check and saves what it saw; the test functions read it back. The
references are computed here, in this process, with no process group:

- `broadcast_string`: rank 0's string on both ranks;
- `host_gather_tree`: the concatenation of both ranks' leaves, in ONE
  collective (the gathers are counted);
- `all_gather_varlen`: 3 rows on rank 0 and 1 on rank 1, padded, with the
  lengths;
- the autograd gather: each rank's gradient, over the ranks' count (DDP's
  average), equals the one-process gradient of the same function of the
  whole batch, exactly in float64;
- BatchNorm in train mode: the ranks' outputs, input gradients, summed
  weight gradients and running statistics equal one process's on the
  whole batch at rtol 1e-12 in float64, the running variance biased.
"""

import os
import sys

import numpy as np
import pytest
import torch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
WORKER_TIMEOUT = 120

torch.set_num_threads(1)


def _inputs():
    rng = np.random.default_rng(7)
    return {
        "x": rng.standard_normal((4, 3)),
        "w": rng.standard_normal((4, 3)),
        "bn_x": rng.standard_normal((4, 3, 2, 2)) * 2 + 1,
        "bn_w": rng.standard_normal((4, 3, 2, 2)),
    }


def _f(y, w):
    """A function of the gathered rows whose gradient mixes them."""
    return (torch.tanh(y) * w).sum() * y.sum()


def worker(out_dir: str) -> None:
    from sm3x_torch.models.layers import BatchNorm
    from sm3x_torch.parallel import collectives as C

    torch.set_num_threads(1)
    assert C.distributed_initialize(backend="gloo")
    rank, world = C.process_info()
    got = {"process_info": (rank, world), "main": C.is_main_process()}
    got["broadcast"] = C.broadcast_string("run/exp_7 é" if rank == 0
                                          else "something else")
    gathers = []
    real = torch.distributed.all_gather

    def counting(*a, **k):
        gathers.append(1)
        return real(*a, **k)

    torch.distributed.all_gather = counting
    tree = {"f": np.full((2, 3), rank + 0.5, np.float32),
            "i": (np.arange(2, dtype=np.int32) + 10 * rank,
                  torch.tensor([[rank == 0], [True]]))}
    got["tree"] = C.host_gather_tree(tree)
    got["tree_gathers"] = len(gathers)
    torch.distributed.all_gather = real
    rows, lengths = C.all_gather_varlen(
        torch.arange(3 if rank == 0 else 1, dtype=torch.float64) + 1)
    got["varlen"], got["lengths"] = rows, lengths
    got["mean"] = C.cross_replica_mean(torch.tensor(float(rank)))
    got["max"] = C.max_over_ranks(5 if rank == 1 else 2)

    inp = {k: torch.from_numpy(v) for k, v in _inputs().items()}
    lo, hi = 2 * rank, 2 * rank + 2
    x = inp["x"][lo:hi].clone().requires_grad_(True)
    _f(C.gather_rows_autograd(x), inp["w"]).backward()
    got["gather_grad"] = x.grad / world

    bn = BatchNorm(3).double().train()
    with torch.no_grad():
        bn.weight.copy_(torch.tensor([1.0, 2.0, -0.5]))
        bn.bias.copy_(torch.tensor([0.1, 0.0, 0.3]))
    bx = inp["bn_x"][lo:hi].clone().requires_grad_(True)
    y = bn(bx)
    (y * inp["bn_w"][lo:hi]).sum().backward()
    got["bn_y"], got["bn_dx"] = y.detach(), bx.grad
    got["bn_dw"] = C.all_reduce_sum(bn.weight.grad)
    got["bn_db"] = C.all_reduce_sum(bn.bias.grad)
    got["bn_state"] = {k: v.clone() for k, v in bn.state_dict().items()}
    torch.save(got, os.path.join(out_dir, f"rank{rank}.pt"))
    C.shutdown()


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    from sm3x_torch.parallel.launch import launch_local

    out = tmp_path_factory.mktemp("collectives")
    env = dict(os.environ, PYTHONPATH=REPO, OMP_NUM_THREADS="1")
    res = launch_local([sys.executable, os.path.abspath(__file__),
                        str(out)], 2, WORKER_TIMEOUT, env=env, cwd=REPO)
    assert all(rc == 0 for rc, _ in res), "\n".join(o[-3000:] for _, o in res)
    return [torch.load(out / f"rank{r}.pt", weights_only=False)
            for r in range(2)]


def test_ranks_know_their_place(ranks):
    assert [g["process_info"] for g in ranks] == [(0, 2), (1, 2)]
    assert [g["main"] for g in ranks] == [True, False]


def test_broadcast_string_gives_rank_0_s(ranks):
    assert [g["broadcast"] for g in ranks] == ["run/exp_7 é"] * 2


def test_host_gather_tree_is_the_concatenation_in_one_collective(ranks):
    for g in ranks:
        np.testing.assert_array_equal(
            g["tree"]["f"], np.concatenate([np.full((2, 3), 0.5, np.float32),
                                            np.full((2, 3), 1.5, np.float32)]))
        assert g["tree"]["f"].dtype == np.float32
        np.testing.assert_array_equal(g["tree"]["i"][0], [0, 1, 10, 11])
        np.testing.assert_array_equal(g["tree"]["i"][1][:, 0],
                                      [True, True, False, True])
        assert isinstance(g["tree"]["i"], tuple)
        assert g["tree_gathers"] == 1


def test_all_gather_varlen_pads_and_reports_lengths(ranks):
    for g in ranks:
        assert g["lengths"].tolist() == [3, 1]
        assert g["varlen"].tolist() == [[1.0, 2.0, 3.0], [1.0, 0.0, 0.0]]


def test_mean_and_max_over_ranks(ranks):
    assert [float(g["mean"]) for g in ranks] == [0.5, 0.5]
    assert [g["max"] for g in ranks] == [5, 5]


def test_autograd_gather_gradient_equals_one_process(ranks):
    inp = {k: torch.from_numpy(v) for k, v in _inputs().items()}
    x = inp["x"].clone().requires_grad_(True)
    _f(x, inp["w"]).backward()
    got = torch.cat([g["gather_grad"] for g in ranks])
    np.testing.assert_array_equal(got.numpy(), x.grad.numpy())


def test_batchnorm_takes_the_global_batch(ranks):
    from sm3x_torch.models.layers import BatchNorm

    inp = {k: torch.from_numpy(v) for k, v in _inputs().items()}
    bn = BatchNorm(3).double().train()
    with torch.no_grad():
        bn.weight.copy_(torch.tensor([1.0, 2.0, -0.5]))
        bn.bias.copy_(torch.tensor([0.1, 0.0, 0.3]))
    bx = inp["bn_x"].clone().requires_grad_(True)
    y = bn(bx)
    (y * inp["bn_w"]).sum().backward()
    tol = dict(rtol=1e-12, atol=1e-12)
    np.testing.assert_allclose(torch.cat([g["bn_y"] for g in ranks]),
                               y.detach(), **tol)
    np.testing.assert_allclose(torch.cat([g["bn_dx"] for g in ranks]),
                               bx.grad, **tol)
    for g in ranks:
        np.testing.assert_allclose(g["bn_dw"], bn.weight.grad, **tol)
        np.testing.assert_allclose(g["bn_db"], bn.bias.grad, **tol)
        for k, v in bn.state_dict().items():
            np.testing.assert_allclose(g["bn_state"][k], v, rtol=1e-12,
                                       err_msg=k)
    # the running variance moved toward the biased variance (Flax)
    var = inp["bn_x"].var(dim=(0, 2, 3), unbiased=False)
    np.testing.assert_allclose(bn.running_var, 0.9 + 0.1 * var, rtol=1e-12)
    for k in ranks[0]["bn_state"]:
        assert torch.equal(ranks[0]["bn_state"][k], ranks[1]["bn_state"][k])


def test_one_process_needs_no_group(monkeypatch):
    from sm3x_torch.parallel import collectives as C

    for k in ("WORLD_SIZE", "RANK"):
        monkeypatch.delenv(k, raising=False)
    assert not C.distributed_initialize()
    assert C.process_info() == (0, 1) and C.is_main_process()
    assert C.broadcast_string("a") == "a"
    tree = C.host_gather_tree({"a": torch.ones(2), "b": np.zeros(3)})
    np.testing.assert_array_equal(tree["a"], np.ones(2))
    x = torch.ones(2, requires_grad=True)
    assert C.gather_rows_autograd(x) is x
    assert C.max_over_ranks(3) == 3
    with pytest.raises(ValueError, match="--num-processes"):
        C.distributed_initialize("localhost:1", None, 0)


def test_process_info_leaves_cuda_alone():
    import subprocess

    probe = ("import torch; from sm3x_torch.parallel import process_info; "
             "from sm3x_torch.utils.misc import setup_logger; "
             "setup_logger(None, 'probe'); print(process_info(), "
             "torch.cuda.is_initialized())")
    out = subprocess.run([sys.executable, "-c", probe], cwd=REPO,
                         capture_output=True, text=True, timeout=120,
                         env=dict(os.environ, PYTHONPATH=REPO))
    assert out.returncode == 0, out.stderr[-2000:]
    assert out.stdout.split() == ["(0,", "1)", "False"]


def test_mesh_and_rows():
    from sm3x_torch.core import mesh
    from sm3x_torch.data.multihost import local_batch_rows

    assert mesh.make_mesh().shape == {"data": 1, "model": 1}
    # one process at --mesh-model 2: the divisibility refusal, both numbers
    with pytest.raises(ValueError, match=r"--mesh-model 2 does not divide "
                       r"the 1 process"):
        mesh.make_mesh(model=2)
    rows = mesh.local_rows(12, rank=1, world=3)
    assert (rows.start, rows.stop, rows.total, rows.size) == (4, 8, 12, 4)
    assert rows.take(np.arange(12)).tolist() == [4, 5, 6, 7]
    assert rows.take(torch.arange(24).view(2, 12), dim=1).tolist() == [
        [4, 5, 6, 7], [16, 17, 18, 19]]
    assert local_batch_rows(mesh.Mesh(data=3, model=2, data_index=2),
                            12).tolist() == [8, 9, 10, 11]
    assert local_batch_rows(mesh.make_mesh(), 5).tolist() == [0, 1, 2, 3, 4]
    with pytest.raises(ValueError, match="not a multiple of the 2"):
        mesh.local_rows(7, 0, 2)
    assert mesh.pad_to_multiple(10, 4) == 12
    assert mesh.current_rows() is None
    with mesh.batch_rows(rows):
        assert mesh.current_rows() is rows
    assert mesh.current_rows() is None


if __name__ == "__main__":
    worker(sys.argv[1])
