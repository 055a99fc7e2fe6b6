"""On-demand batch staging for sampled cohorts (counterpart of
``repro/fed/population/batches.py``).

Each client's staging generator derives from the population's
``SeedSequence((seed, tag, client_id, salt))`` stream
(``ClientPopulation.client_rng``), so staging the same client with the
same salt yields the same batches whatever the population size and
whatever cohort it rode in.  Only the sampled cohort is staged: peak
memory is (S, K, ...).
"""
from __future__ import annotations

from repro_torch.fed.staging import _stack_steps, stack_clients


def stage_population_batches(client_batch_fn, population, cohort,
                             local_steps: int, device, salt: int = 0):
    """A cohort's batches, (S, K, ...) stacked on ``device``, each client
    drawing from its own generator.  ``salt`` separates rounds (sync: the
    round index; async: the client's dispatch count)."""
    return stack_clients([
        _stack_steps(client_batch_fn, int(cid), local_steps,
                     population.client_rng(int(cid), salt))
        for cid in cohort], device)


def stage_client_population_batches(client_batch_fn, population, cid: int,
                                    local_steps: int, device, salt: int = 0):
    """One client's batches with a leading (1, K, ...) axis from its own
    generator (the async runtime stages per dispatch)."""
    return stage_population_batches(client_batch_fn, population, [cid],
                                    local_steps, device, salt=salt)
