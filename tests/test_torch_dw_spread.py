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


# the round-2 distances measured on the card for the first tensor-core dw
# (kernel d, then the eight noise runs' d) at seeds 0, 1, 2 (PERF.md §6), as
# inputs of the rule
MEASURED = [
    (0.139832, [0.0880394, 0.101585, 0.0495071, 0.0535765, 0.0509005, 0.01408,
                0.0309381, 0.0651608]),
    (0.149372, [0.0550394, 0.0589285, 0.10109, 0.124428, 0.0907288, 0.0921497,
                0.0567894, 0.134913]),
    (0.0839939, [0.0368824, 0.097681, 0.078558, 0.128507, 0.101344, 0.0819302,
                 0.0929661, 0.112473]),
]


@pytest.mark.parametrize("candidate_d,outcome", [
    ((0.2, 0.16, 0.01), "a"),       # beyond every noise run at seeds 0 and 1
    ((0.2, 0.16, 0.2), "a"),        # at all three
    ((0.2, 0.01, 0.01), "b"),       # at one seed only
    ((0.05, 0.134913, 0.128507), "b"),   # ties with the largest noise run do not count
    ((0.0, 0.0, 0.0), "b")])
def test_a_candidate_dw_takes_the_kernels_rule(candidate_d, outcome):
    verdicts = [study.spread_verdict(d, noise) for d, (_, noise) in zip(candidate_d, MEASURED)]
    assert study.candidate_outcome(verdicts) == outcome
    assert (outcome == "a") is study.spread_rule(verdicts)


def test_the_kernels_own_verdict_is_unchanged_by_a_candidate():
    kernel = [study.spread_verdict(d, noise) for d, noise in MEASURED]
    assert kernel == [True, True, False]
    assert [study.spread_rank(d, noise) for d, noise in MEASURED] == [1, 1, 6]
    assert study.spread_rule(kernel)
    assert "twin" in study.DW_CANDIDATES and "kernel" not in study.DW_CANDIDATES
