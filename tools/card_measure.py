"""Measurement helpers shared by ``chip_smoke.py`` and
``tools/cuda_on_silicon.py``: the card's peak rates, its name and power
limit, CUDA-event timing, and the check of a top-k kernel's lists against
its plain version's, and the dense library yardstick of the cosine kernel.
Imports torch only inside its functions."""

import subprocess

# published H100 SXM peaks (NVIDIA data sheet): float32 outside the tensor
# cores, and HBM3 bandwidth
PEAK_F32_FLOPS = 67e12
PEAK_BYTES = 3.35e12


def card_line():
    """The card's name and power limit, as ``nvidia-smi`` gives them."""
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    )
    return out.stdout.strip().splitlines()[0]


def time_ms(fn, reps, warm=3):
    """Milliseconds per call of ``fn`` by CUDA events over ``reps`` calls,
    after ``warm`` calls."""
    import torch

    for _ in range(warm):
        fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def plain_scores(U, V, bias=None):
    """Full float32 (B, N) scores, TF32 off."""
    from cornac_tpu_torch.ops.dispatch import full_f32

    with full_f32():
        s = U @ V.T
    return s if bias is None else s + bias


def compare_topk(ks, ki, ps, pi, S, what, exact=False, rtol=1e-5, atol=1e-5):
    """Hold the kernel's (scores, items) to the plain version's. Unless
    ``exact``, index equality is relaxed only where the plain scores next
    to the position lie within the score tolerance of each other and the
    kernel's item scores (by the plain product ``S``) within it of the
    plain item's. Returns (max abs score error, relaxed positions)."""
    import torch

    k = ki.shape[1]
    if ks.shape != ps[:, :k].shape or not torch.isfinite(ks).all():
        raise AssertionError(f"{what}: bad kernel output {tuple(ks.shape)}")
    err = (ks - ps[:, :k]).abs()
    if exact and not (torch.equal(ks, ps[:, :k]) and torch.equal(ki, pi[:, :k])):
        raise AssertionError(f"{what}: kernel differs from the plain version on exact data "
                             f"(max |err| {err.max().item():.3e})")
    if not torch.all(err <= atol + rtol * ps[:, :k].abs()):
        raise AssertionError(f"{what}: scores differ by up to {err.max().item():.3e}")
    if (torch.sort(ki.long(), dim=1).values.diff(dim=1) == 0).any():
        raise AssertionError(f"{what}: an item appears twice in a row")
    bad = ki != pi[:, :k]
    n_bad = int(bad.sum())
    if n_bad and exact:
        raise AssertionError(f"{what}: {n_bad} item mismatches where scores tie exactly")
    if n_bad:
        tol = atol + rtol * ps.abs()
        near = torch.zeros_like(bad)
        near[:, 1:] |= (ps[:, 1:k] - ps[:, : k - 1]).abs() <= tol[:, 1:k]
        if ps.shape[1] > k:
            near |= (ps[:, : k] - ps[:, 1 : k + 1]).abs() <= tol[:, :k]
        else:
            near[:, : k - 1] |= (ps[:, : k - 1] - ps[:, 1:k]).abs() <= tol[:, : k - 1]
        true_s = S.gather(1, ki.long())
        same = (true_s - ps[:, :k]).abs() <= tol[:, :k]
        if not torch.all(near[bad] & same[bad]):
            raise AssertionError(f"{what}: {n_bad} item mismatches beyond near-ties")
    return err.max().item(), n_bad


def library_cosine_topk(W, k):
    """The dense library yardstick: two ``torch.matmul`` (TF32 off), the
    elementwise step and ``torch.topk``. Timed only; the port never calls
    it. It is not ``co_support_cosine``: that follows the JAX formula with
    three products, where ``d2 = B·(W∘W)ᵀ`` is just ``d1ᵀ``, and the
    yardstick should be the least library work for the same function."""
    import torch

    from cornac_tpu_torch.ops.dispatch import full_f32

    with full_f32():
        num, d1 = torch.matmul(W, W.T), torch.matmul(W * W, (W != 0).float().T)
    sim = torch.where(num != 0, num / torch.clamp_min(torch.sqrt(d1) * torch.sqrt(d1.T), 1e-12), 0.0)
    sim.fill_diagonal_(-3e38)
    return torch.topk(sim, k, dim=1)
