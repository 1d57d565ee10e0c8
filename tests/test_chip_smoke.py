"""chip_smoke.py's phases at a tiny size on the CPU, comparisons included.

On a GPU the script runs the same phase functions at the repo's fleet
sizes; here each one runs at ``TINY`` so a broken phase (wrong shapes,
arguments, control flow or reference) shows up without a card.  The
four-card phases run on four of conftest's virtual CPU devices.
"""
import pytest

import chip_smoke

ONE_CARD = ["single", "de_fleet", "bfgs_fleet", "nlls_fleet", "cmaes_fleet",
            "pso_sann", "roots", "parity", "memory"]


@pytest.mark.parametrize("phase", ONE_CARD + sorted(chip_smoke.FOUR_PHASES))
def test_phase_at_tiny_size(phase):
    run = chip_smoke.Runner()
    if phase == "memory":
        chip_smoke.phase_roots(chip_smoke.TINY, {}, run, 0)
    fn = chip_smoke.PHASES.get(phase) or chip_smoke.FOUR_PHASES[phase]
    res = chip_smoke.run_phase(phase, fn, chip_smoke.TINY, run, 0)
    assert res["ok"] and res["phase"] == phase
    assert res["wall_s"] >= res["compile_s"] >= 0.0
