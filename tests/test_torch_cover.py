"""The port's serving covers (``repro_torch/serving/cover.py``, a numpy
copy) held equal to the JAX package's: for every P <= 64 the plan of every
placement defined at P, and degraded covers around dead devices."""

import numpy as np
import pytest

from repro.core import placement as r_placement
from repro.serving import cover as r_cover
from repro_torch.core import placement as t_placement
from repro_torch.serving import cover as t_cover


def _same_plan(a, b):
    assert (a.P, a.A, a.devices, a.placement) == (b.P, b.A, b.devices,
                                                  b.placement)
    np.testing.assert_array_equal(a.block_owner, b.block_owner)
    np.testing.assert_array_equal(a.mask_table(), b.mask_table())
    assert a.mask_table().dtype == b.mask_table().dtype == np.float32


@pytest.mark.parametrize("P", list(range(1, 65)))
def test_cover_plans_match_reference(P):
    names = sorted(n for n, cls in t_placement.registered_placements().items()
                   if cls.supports(P))
    assert names == sorted(n for n, cls in
                           r_placement.registered_placements().items()
                           if cls.supports(P))
    _same_plan(t_cover.build_cover(P), r_cover.build_cover(P))
    for name in names:
        _same_plan(t_cover.build_cover(P, name), r_cover.build_cover(P, name))
    A = t_placement.get_placement("cyclic", P).shifts
    assert t_cover.closed_form_cover(P, A) == r_cover.closed_form_cover(P, A)
    assert t_cover.greedy_cover(P, A) == r_cover.greedy_cover(P, A)
    assert t_cover.step_cover(P, A) == r_cover.step_cover(P, A)


@pytest.mark.parametrize("P", list(range(2, 64)))
def test_degraded_covers_match_reference(P):
    """Every P below 64 (at P = 64 the exact search around a dead device
    takes about a minute in each package)."""
    rng = np.random.default_rng(P)
    dead_sets = [(), (0,), (1, P // 2)]
    if P in (3, 5, 8, 13, 22, 31, 40):
        dead_sets.append(tuple(rng.choice(P, size=max(1, P // 4),
                                          replace=False)))
    for dead in dead_sets:
        try:
            want = r_cover.build_degraded_cover(P, dead=dead)
        except RuntimeError as e:
            with pytest.raises(RuntimeError, match="lost"):
                t_cover.build_degraded_cover(P, dead=dead)
            assert "lost" in str(e)
            continue
        got = t_cover.build_degraded_cover(P, dead=dead)
        _same_plan(got, want)
        assert not set(got.devices) & set(int(d) for d in dead)
