"""The port's CUDA kernels on the card, against their plain versions.

Every test here needs an NVIDIA card and skips without one. The file
imports nothing of JAX, so on a machine with a card and no JAX it runs
without the suite's ``conftest.py``:

    python -m pytest tests/test_torch_cuda.py -m cuda --noconftest -q
"""

import numpy as np
import pytest
import torch

from cornac_tpu_torch.data import Dataset
from cornac_tpu_torch.models import BPR, TPUExactANN
from cornac_tpu_torch.ops.fused_topk import FUSED_TOPK, fused_topk, fused_topk_torch

pytestmark = pytest.mark.cuda


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")


def _on(card, *arrays):
    return [None if a is None else torch.from_numpy(a).to(card) for a in arrays]


@pytest.mark.parametrize("k", [1, 100, 600, 3000])
@pytest.mark.parametrize("bias", [False, True])
def test_kernel_matches_plain(card, k, bias):
    rng = np.random.RandomState(k)
    U, V, b = _on(card, rng.randn(77, 51).astype(np.float32),
                  rng.randn(3000, 51).astype(np.float32),
                  rng.randn(3000).astype(np.float32) if bias else None)
    before = FUSED_TOPK.launches
    s, i = fused_topk(U, V, k, bias=b)
    s_ref, i_ref = fused_topk_torch(U, V, k, b)
    torch.cuda.synchronize()
    assert FUSED_TOPK.launches == before + 1
    assert torch.equal(i, i_ref)
    torch.testing.assert_close(s, s_ref, rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("k", [50, 1300])
def test_exact_ties_in_index_order(card, k):
    # entries in {-1, 0, 1}: integer scores, exact in float32 whatever the
    # order of the sums, so the order inside each tie is the whole answer
    rng = np.random.RandomState(11)
    U, V = _on(card, rng.randint(-1, 2, (21, 4)).astype(np.float32),
               rng.randint(-1, 2, (1300, 4)).astype(np.float32))
    s, i = fused_topk(U, V, k)
    s_ref, i_ref = fused_topk_torch(U, V, k)
    assert torch.equal(i, i_ref) and torch.equal(s, s_ref)


def test_kernel_refuses_bad_inputs(card):
    U = torch.zeros(4, 8, device=card)
    V = torch.zeros(16, 8, device=card)
    for args in ((U.double(), V.double(), 3), (U, V[:, :4], 3), (U, V, 17), (U, V.T, 3)):
        with pytest.raises(ValueError):
            FUSED_TOPK(*args)


def test_serving_answers_match_the_cpu(card):
    # quarter-integer factors: every score is exact in float32, so the
    # kernel on the card and the plain version on the CPU must agree
    # item for item, ties included
    rng = np.random.RandomState(3)
    n_users, n_items, k = 120, 900, 6
    pairs = sorted({(rng.randint(n_users), rng.randint(n_items)) for _ in range(3000)})
    train = Dataset.from_uir([(f"u{u}", f"i{i}", 1.0) for u, i in pairs], seed=1)
    init = {
        "U": rng.randint(-4, 5, (train.num_users, k)).astype(np.float32) / 4,
        "V": rng.randint(-4, 5, (train.num_items, k)).astype(np.float32) / 4,
        "Bi": rng.randint(-4, 5, train.num_items).astype(np.float32) / 4,
    }
    uids = list(train.uid_map)[:50]
    answers = []
    for device in (card, "cpu"):
        bpr = BPR(k=k, trainable=False, init_params=init, device=device).fit(train)
        ann = TPUExactANN(bpr)
        ann.build_index()
        answers.append([
            model.recommend_batch(uids, k=10, remove_seen=seen, train_set=train)
            for model in (bpr, ann) for seen in (False, True)
        ] + [ann.recommend(uids[0], train_set=train)])
    assert answers[0] == answers[1]
