"""Faults planted in the program underneath a run, each one a training
cell can have: the CPU tests see each come out not correct, and
``calibrate.py`` reads them at a cell's own size.  A plant's
``scenario(scn)`` runs before the experiment is built, its
``experiment(exp)`` after."""


class StateUnchanged:
    """Each round hands the server state back as it came."""

    def scenario(self, scn):
        pass

    def experiment(self, exp):
        inner = exp.round_fn

        def round_fn(server, cstate, cohort, batches, seed):
            _, cstate, metrics = inner(server, cstate, cohort, batches, seed)
            return server, cstate, metrics
        exp.round_fn = round_fn


class HalfBatch:
    """Each step's loss over the first half of its rows."""

    def scenario(self, scn):
        inner = scn.loss_fn
        scn.loss_fn = lambda p, b: inner(
            p, {k: v[: v.shape[0] // 2] for k, v in b.items()})

    def experiment(self, exp):
        pass


class ClientLeftOut:
    """The last client of the cohort is left out of the round (on one card,
    the fault that stands for an exchange left out)."""

    def scenario(self, scn):
        pass

    def experiment(self, exp):
        inner = exp.round_fn

        def round_fn(server, cstate, cohort, batches, seed):
            return inner(server, cstate, cohort[:-1],
                         {k: v[:-1] for k, v in batches.items()}, seed)
        exp.round_fn = round_fn


# by the names of ``reference.fedround.FAULTS`` where the reference has
# the same fault
PLANTS = {"state_unchanged": StateUnchanged, "half_batch": HalfBatch,
          "drop_client": ClientLeftOut}
