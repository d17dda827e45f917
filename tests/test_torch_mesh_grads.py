"""A train step of the port with its state placed over 4 gloo ranks ≡
the same step of the plain state on one rank (the port alone, smoke
configs, float32): where the local blocks of attention and of the
recurrences take their gradients (``sharding.specs.on_blocks``), each
parameter's gradient sums the batch's blocks once.

* RWKV6 on data 2 × model 2: the WKV scan on the blocks of the batch and
  the heads, its ``u`` whole;
* Zamba2 on data 2 × model 2: the chunked SSD on the blocks of the batch
  and the heads (``Bm``/``Cm`` whole), and the shared attention block;
* Qwen3-32B on data 1 × model 4: 8 query heads over 4 ranks, its 2 key
  heads whole, each rank reading the key head of its query heads.

Loss and ``grad_norm`` within 1e-5 of their scale, every parameter after
the step within 0.01 of the learning rate.
"""
import pytest

import _mesh_ranks as mr


@pytest.fixture(scope="module")
def grad_runs(tmp_path_factory):
    return mr.spawn(mr.grads_rank_main, 4,
                    str(tmp_path_factory.mktemp("grads")), "grads")


@pytest.mark.parametrize("arch", [a for a, _ in mr.GRAD_CASES])
def test_train_step_on_four_ranks_matches_one_rank(grad_runs, arch):
    for out in grad_runs:
        for k in ("loss", "grad_norm"):
            plain = float(out[f"{arch}/plain/{k}"])
            placed = float(out[f"{arch}/placed/{k}"])
            assert abs(placed - plain) <= 1e-5 * max(1.0, abs(plain)), k
        lr = float(out[f"{arch}/lr"])
        keys = [k for k in out if k.startswith(f"{arch}/delta/")]
        assert len(keys) > 5
        for k in keys:
            assert float(out[k]) <= 0.01 * lr, k
