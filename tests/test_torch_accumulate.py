"""``ops/accumulate.py::accumulate_plan``, the launch of the row-accumulation
kernel, on the CPU: every table row and column owned by exactly one block,
shared memory within the limit given, a grid of at least one block, the
column split at large d, and the grids it gives at the trainers' shapes and
at the serving width, for an H100 (132 SMs, 232,448 bytes of shared memory
a block may opt into). The kernel's arithmetic is
``tests/test_torch_train_ops.py``'s; on the card ``tests/test_torch_cuda.py``
holds the kernel to the plain version bit for bit.
"""

import pytest

from cornac_tpu_torch.ops.accumulate import (
    FIXED_BYTES, MAX_COLS, MAX_INDEX, MAX_PER_LANE, THREADS, WARPS, accumulate_plan, smem_bytes)

H100 = (132, 232_448)
SMALLER = (16, 150_000)  # a card with less shared memory a block


def _blocks(plan, R, d):
    """The (row range, column range) each block of ``plan`` owns."""
    return [((x * plan.rows, min((x + 1) * plan.rows, R)), (y * plan.cols, min((y + 1) * plan.cols, d)))
            for x in range(plan.grid[0]) for y in range(plan.grid[1])]


@pytest.mark.parametrize("R,B,d", [
    (1, 1, 1), (7, 5, 3), (50, 3_000, 1), (943, 4_096, 11), (1_682, 8_192, 11),
    (10_000, 32_768, 33), (100_000, 16_384, 33), (300, 20_000, 200), (131, 64, 65),
    (480_000, 16_384, 51), (2_000_000, 4_096, 33), (64, 40_000, 11), (5_000, 100, 129),
])
@pytest.mark.parametrize("limits", [H100, SMALLER])
def test_plan_covers_every_row_and_column_once(R, B, d, limits):
    sms, smem_limit = limits
    plan = accumulate_plan(R, B, d, sms, smem_limit)
    assert plan.grid[0] >= 1 and plan.grid[1] >= 1
    blocks = _blocks(plan, R, d)
    # each (row, column) of the table falls in exactly one block, and no
    # block is empty
    assert all(r1 > r0 and c1 > c0 for (r0, r1), (c0, c1) in blocks)
    rows = sorted({rr for rr, _ in blocks})
    cols = sorted({cc for _, cc in blocks})
    assert rows[0][0] == 0 and rows[-1][1] == R and all(a[1] == b[0] for a, b in zip(rows, rows[1:]))
    assert cols[0][0] == 0 and cols[-1][1] == d and all(a[1] == b[0] for a, b in zip(cols, cols[1:]))
    assert len(blocks) == len(rows) * len(cols)
    # within the kernel's limits and the shared memory given
    assert 1 <= plan.cols <= MAX_COLS and 1 <= plan.rows <= MAX_INDEX
    assert 1 <= plan.per_lane <= MAX_PER_LANE and 1 <= plan.cap < MAX_INDEX
    assert plan.smem == smem_bytes(plan.rows, plan.cols, plan.cap) <= smem_limit
    assert plan.smem == (4 * (plan.rows * plan.cols + (plan.cap + 1) * plan.cols + plan.cap)
                         + FIXED_BYTES + 2 * WARPS * -(-plan.rows // WARPS) + plan.rows)
    # the stage holds at least 256 updates, or the whole batch
    assert plan.cap >= min(B, 256)


@pytest.mark.parametrize("d,grid_cols,cols", [
    (1, 1, 1), (11, 1, 11), (33, 1, 33), (64, 1, 64), (65, 2, 33), (128, 2, 64),
    (129, 3, 43), (200, 4, 50),
])
def test_plan_splits_columns_only_past_a_block(d, grid_cols, cols):
    plan = accumulate_plan(10_000, 16_384, d, *H100)
    assert (plan.grid[1], plan.cols) == (grid_cols, cols)


@pytest.mark.parametrize("R,B,d,row_blocks,rows", [
    (10_000, 32_768, 33, 132, 76),   # BPR's V update at full width (positives + negatives)
    (100_000, 16_384, 33, 132, 758),  # its U update
    (1_682, 8_192, 11, 130, 13),     # the bench shape's V update
    (943, 4_096, 11, 118, 8),        # its U update
])
def test_plan_fills_the_card_once_at_the_trainer_shapes(R, B, d, row_blocks, rows):
    # the sums fit many times over: as few blocks as fill the 132 SMs, each
    # re-reading the batch's ids once, with the most ids a lane per round,
    # and room in the stage for twice a block's share of uniform ids, so
    # that such a batch is summed once, after the scan
    plan = accumulate_plan(R, B, d, *H100)
    assert plan.grid == (row_blocks, 1) and plan.rows == rows
    assert plan.grid[0] <= H100[0] and plan.per_lane == MAX_PER_LANE
    assert plan.cap >= min(B, 2 * B / plan.grid[0])


def test_plan_at_the_serving_width_is_bound_by_shared_memory():
    # 480,000 x 51: 98 MB of sums; each block holds as many rows as fit
    # beside a stage of 256 updates, so the grid is the least that holds
    # the table, several waves of the card
    R, B, d = 480_000, 16_384, 51
    sms, smem_limit = H100
    plan = accumulate_plan(R, B, d, sms, smem_limit)
    assert plan.cols == 51 and plan.grid[1] == 1 and plan.cap >= 256
    assert plan.grid[0] == -(-R // plan.rows) > 4 * sms
    assert 4 * plan.rows * plan.cols > 0.4 * smem_limit
    # one more row per block would not fit beside that stage
    assert smem_bytes(plan.rows + WARPS, plan.cols, 256) > smem_limit


def test_plan_small_batches_and_refusals():
    assert accumulate_plan(10, 1, 4, *H100).per_lane == 1
    assert accumulate_plan(10, THREADS + 1, 4, *H100).per_lane == 2
    assert accumulate_plan(10, 3, 4, *H100).cap == 3
    for R, d, smem_limit in ((0, 4, 232_448), (10, 0, 232_448), (10, 64, 2_000)):
        with pytest.raises(ValueError):
            accumulate_plan(R, 100, d, 132, smem_limit)
