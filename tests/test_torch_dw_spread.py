"""The pre-registered spread test of ``lm_dw_study.py --spread`` on made-up
distances: the rule that decides whether the tensor-core dw's loss gap in
the federated LM cell stands (ROADMAP section 3, Open 1)."""
import sys
from pathlib import Path

import pytest

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))
import lm_dw_study as study  # noqa: E402

NOISE = [1e-3, 4e-3, 2e-3, 8e-4, 3e-3, 5e-3, 1.5e-3, 2.5e-3]


@pytest.mark.parametrize("kernel_d,exceeds,rank", [
    (6e-3, True, 1), (5e-3, False, 2), (4.5e-3, False, 2), (1e-4, False, 9),
    (2.2e-3, False, 5)])
def test_a_seed_counts_only_when_the_kernel_exceeds_every_noise_run(kernel_d, exceeds, rank):
    assert study.spread_verdict(kernel_d, NOISE) is exceeds
    assert study.spread_rank(kernel_d, NOISE) == rank


@pytest.mark.parametrize("verdicts,stands", [
    ([True, True, True], True), ([True, False, True], True), ([False, True, True], True),
    ([True, False, False], False), ([False, False, False], False), ([False, True, False], False)])
def test_the_fault_stands_at_two_seeds_of_three(verdicts, stands):
    assert study.spread_rule(verdicts) is stands


def test_the_rules_chance_level_and_its_runs():
    # eight noise runs: 1/9 a seed; two of three or more: 25/729
    assert study.spread_chance() == pytest.approx(25 / 729, rel=1e-12)
    assert len(study.SPREAD_NOISE_SEEDS) == 8 and study.RUN_SEEDS == (0, 1, 2)
    # noise seeds unused by the earlier runs (0 .. SEEDS - 1 on the exact product)
    assert min(study.SPREAD_NOISE_SEEDS) >= max(study.SEEDS, study.KERNEL_SEEDS)
    assert study.SPREAD_ROUND == study.ROUNDS == 2
