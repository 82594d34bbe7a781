"""The launch planners of the port's fused round and cut kernels.

`inner_round.round_plan` sizes the one-launch fused round (blocks, slice
width, on-chip or streamed A, shared memory a block) and
`cut_eval.cut_grid` the grid of matvec and vecmat.  Both are pure Python,
so they are tested here on the CPU against a model of the H100: 132 SMs,
233,472 bytes of shared memory an SM, 232,448 a block, at most two blocks
an SM (the kernels' launch bounds).
"""
import numpy as np
import pytest

from repro_torch.kernels import cut_eval, inner_round
from repro_torch.kernels.inner_round import (MAX_ROWS, round_plan,
                                             round_smem)

SMS = 132
SMEM_SM, SMEM_BLOCK, STATIC = 233_472, 232_448, 384


def h100_occupancy(on_chip, smem):
    """Blocks an SM holds: shared memory (1 KB reserved a block) and the
    kernel's bound of two."""
    if smem + STATIC > SMEM_BLOCK:
        return 0
    return min(2, SMEM_SM // (smem + STATIC + 1024))


def per_sm_plan(p, d, es, per_sm):
    """The on-chip launch at `per_sm` blocks an SM, as round_plan forms it."""
    g = min(per_sm * SMS, max(1, -(-d // inner_round.MIN_COLS)))
    cw = (-(-d // g) + 7) // 8 * 8
    return -(-d // cw), cw, round_smem(p, cw, es, True)


SHAPES = [(1, 7), (3, 33), (3, 1025), (13, 5000), (8, 57_366),
          (8, 242_628), (2, 925_590), (64, 242_628), (24, 242_628),
          (28, 242_628), (4096, 37), (4096, 100_000), (1, 10_000_000),
          (5, 100_003)]


@pytest.mark.parametrize("p,d", SHAPES)
@pytest.mark.parametrize("es", [4, 2])
def test_round_slices_cover_every_column_once(p, d, es):
    plan = round_plan(p, d, es, SMS, h100_occupancy)
    assert plan.cw % 8 == 0 and plan.cw >= 8
    starts = np.arange(plan.blocks) * plan.cw
    ends = np.minimum(starts + plan.cw, d)
    assert starts[0] == 0 and ends[-1] == d
    assert np.all(ends > starts)
    assert np.array_equal(starts[1:], ends[:-1])
    assert int((ends - starts).sum()) == d


@pytest.mark.parametrize("p,d", SHAPES)
@pytest.mark.parametrize("es", [4, 2])
def test_round_holds_a_on_chip_exactly_when_the_slice_fits(p, d, es):
    plan = round_plan(p, d, es, SMS, h100_occupancy)
    fits = []
    for per_sm in (2, 1):
        blocks, cw, smem = per_sm_plan(p, d, es, per_sm)
        if h100_occupancy(True, smem) * SMS >= blocks:
            fits.append((blocks, cw, smem))
    assert plan.on_chip == bool(fits)
    if fits:
        assert (plan.blocks, plan.cw, plan.smem) == fits[0]
    else:
        assert plan.smem == round_smem(p, plan.cw, es, False)
    # every block of the cooperative launch is resident at once
    assert h100_occupancy(plan.on_chip, plan.smem) * SMS >= plan.blocks


@pytest.mark.parametrize("p,d,es,on_chip,blocks", [
    (8, 242_628, 4, True, 264),     # white-wine: A on chip, two a SM
    (2, 925_590, 4, True, 264),     # domain adaptation
    (8, 242_628, 2, True, 264),
    (64, 242_628, 4, False, 264),   # 62 MB: streamed
    (3, 1025, 4, True, 5),          # a block spans >= 256 columns
    (1, 7, 4, True, 1),
])
def test_round_plan_at_the_main_shapes(p, d, es, on_chip, blocks):
    plan = round_plan(p, d, es, SMS, h100_occupancy)
    assert (plan.on_chip, plan.blocks) == (on_chip, blocks)


def test_round_plan_takes_one_block_a_sm_when_two_do_not_fit():
    # 20 rows of white-wine in f32: 89 KB a block at 920 columns, but an
    # SM here holds one block, so 264 blocks are never all resident; at
    # 1,840 columns a block takes 177 KB, one on each SM
    def one_block_an_sm(on_chip, smem):
        return 1 if smem <= 200_000 else 0
    assert round_smem(20, 920, 4, True) == 88_960
    assert round_smem(20, 1840, 4, True) == 177_280
    plan = round_plan(20, 242_628, 4, SMS, one_block_an_sm)
    assert plan.on_chip and plan.blocks == SMS and plan.cw == 1840


def test_round_smem_layout():
    # mbarriers (2 + 8 pieces), w, four vector slices, eight rows of A:
    # the bytes the kernel's layout asked for at white-wine on the card
    assert round_smem(8, 920, 4, True) == 80 + 32 + 16 * 924 + 8 * 3696
    assert round_smem(8, 920, 4, True) == 44_464
    assert round_smem(4096, 8, 4, False) == 16_384
    # 33 rows: two rows a piece, 17 pieces
    assert round_smem(33, 8, 2, True) == 160 + 144 + 16 * 12 + 33 * 32


@pytest.mark.parametrize("p", [0, MAX_ROWS + 1, 10_000])
def test_round_plan_refuses_row_counts_the_kernel_does_not_take(p):
    with pytest.raises(ValueError, match="cut rows"):
        round_plan(p, 1000, 4, SMS, h100_occupancy)


def test_round_plan_raises_where_nothing_fits():
    with pytest.raises(ValueError, match="fits"):
        round_plan(8, 1000, 4, SMS, lambda on_chip, smem: 0)


@pytest.mark.parametrize("p,d", SHAPES)
@pytest.mark.parametrize("es", [4, 2])
def test_cut_grid_covers_every_column_once(p, d, es):
    blocks, cw = cut_eval.cut_grid(p, d, es, SMS)
    assert cw % 8 == 0 and 1 <= blocks <= 2 * SMS
    assert (blocks - 1) * cw < d <= blocks * cw
    # no more blocks than min_cols-wide blocks would need (min_cols: in
    # the 8-row kernels, 256 threads x 16 bytes of each row)
    min_cols = 512 if p <= 2 else 256 * 16 // es
    assert blocks <= max(1, -(-d // min_cols))


def test_cut_grid_at_the_main_shapes():
    assert cut_eval.cut_grid(8, 242_628, 4, SMS) == (237, 1024)
    assert cut_eval.cut_grid(8, 242_628, 2, SMS) == (119, 2040)
    assert cut_eval.cut_grid(2, 925_590, 4, SMS) == (264, 3512)
