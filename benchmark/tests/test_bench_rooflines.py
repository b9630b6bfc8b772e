"""Each copied count function gives the operations and bytes of its
chip_smoke.py original, at the main path's shapes (one 480x960 request,
a 4x192x384 step) and at shapes with odd and small extents."""

import pytest

from harness import rooflines as rl

REQUEST = dict(conv=(1, 64, 12, 160, 320), feat=(1, 12, 160, 320),
               cost=(1, 64, 160, 320), dz=(1, 64, 12, 160, 320))
STEP = dict(conv=(4, 64, 12, 64, 128), feat=(4, 12, 64, 128),
            cost=(4, 64, 64, 128), dz=(4, 64, 12, 64, 128))
ODD = dict(conv=(2, 17, 24, 9, 31), feat=(2, 12, 9, 31),
           cost=(2, 8, 9, 31), dz=(2, 8, 12, 9, 31))


@pytest.fixture(scope="module")
def smoke():
    """chip_smoke.py with its division by a peak taken out: each bound
    returns the (flops, bytes) it was given."""
    import chip_smoke

    saved = chip_smoke._bound, chip_smoke.tf32_bound
    chip_smoke._bound = lambda flops, nbytes, per_flop=None: (flops, nbytes)
    chip_smoke.tf32_bound = lambda flops, nbytes, eb: (flops, nbytes)
    yield chip_smoke
    chip_smoke._bound, chip_smoke.tf32_bound = saved


@pytest.mark.parametrize("s", [REQUEST, STEP, ODD], ids=["request", "step", "odd"])
def test_counts_equal_chip_smoke(smoke, s):
    nd = s["cost"][1]
    cases = [
        (smoke.conv_bound(s["conv"], 24), rl.conv_work(s["conv"], 24)),
        (smoke.conv_bound(s["conv"], 12, eb=2), rl.conv_work(s["conv"], 12, eb=2)),
        (smoke.cvstem_bound(s["feat"], nd, 12), rl.cvstem_work(s["feat"], nd, 12)),
        (smoke.disp_bound(s["cost"], 3 * nd, 3), rl.disp_work(s["cost"], 3 * nd, 3)),
        (smoke.dw_bound(s["conv"], 12), rl.dw_work(s["conv"], 12)),
        (smoke.cvstem_dxy_bound(s["dz"], 24, nd),
         rl.cvstem_dxy_work(s["dz"], 24, nd)),
        (smoke.cvstem_dw_bound(s["feat"], s["dz"], nd),
         rl.cvstem_dw_work(s["feat"], s["dz"], nd)),
        (smoke.disp_bwd_bound(s["cost"], 3 * nd, 3),
         rl.disp_bwd_work(s["cost"], 3 * nd, 3)),
        (smoke.shear_bound((s["feat"][0], 9) + s["dz"][2:], nd, relu=True),
         rl.shear_work((s["feat"][0], 9) + s["dz"][2:], nd, relu=True)),
        (smoke.shear_adj_bound(s["dz"], nd), rl.shear_adj_work(s["dz"], nd)),
    ]
    b, d, c, h, w = s["conv"]
    for tr in (False, True):
        for target in ((d // 2, h // 2, w // 2), (2 * d, 2 * h, 2 * w)):
            cases.append((smoke.resize_bound(s["conv"], *target, True, tr),
                          rl.resize_work(s["conv"], *target, True, tr)))
    for got, want in cases:
        assert tuple(map(float, got)) == tuple(map(float, want))


def test_bound_takes_the_slower_of_operations_and_bytes():
    assert rl.bound_s(495e12, 0.0) == pytest.approx(1.0)
    assert rl.bound_s(0.0, 3.35e12) == pytest.approx(1.0)
    assert rl.bound_s(495e12, 2 * 3.35e12) == pytest.approx(2.0)
