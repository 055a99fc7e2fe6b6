"""The benchmark's run on the CPU at toy sizes: the program's checked rounds
against the plain reference, the TF32 control coming out not correct, and
each fault a training cell can have, planted in the program underneath,
coming out not correct.  The run is the harness's own (``execute``), with
its look for a card skipped."""
import io

import pytest
import torch

from fedbench import checks, harness, spec, toy
from fedbench.faults import ClientLeftOut, HalfBatch, StateUnchanged

SEED = 1


@pytest.fixture(scope="module")
def toys(tmp_path_factory):
    root = tmp_path_factory.mktemp("fedbench_toys")
    wls = toy.write(str(root))
    threads = torch.get_num_threads()
    torch.set_num_threads(1)        # toy shapes: one thread is fastest
    yield spec.Catalog([str(root)]), toy.manifest(wls), \
        {w["name"]: w for w in wls}
    torch.set_num_threads(threads)


def _execute(toys, name, plant=None):
    cat, man, wls = toys
    return harness.execute(man, wls[name], cat, seed=SEED, seconds=0,
                           trace=False, device="cpu", plant=plant,
                           guard=False, stream=io.StringIO())


@pytest.mark.parametrize("name", ["vit_toy.muon_toy", "lm_toy.muon_toy",
                                  "lm_toy.soap_toy"])
def test_program_round_agrees_with_reference(toys, name):
    res = _execute(toys, name)
    assert res["correct"], res["checks"]
    assert res["attempted"] == 1 and res["failed"] == 0
    assert list(res)[-1] == "checks"
    assert set(res["metrics"]) == {"round_s", "peak_mem_GiB", "setup_s"}


@pytest.mark.parametrize("name", ["lm_toy.muon_toy", "lm_toy.soap_toy"])
def test_tf32_control_is_not_correct(toys, name):
    cat, _, wls = toys
    wl = wls[name]
    run = harness.Run(wl, cat.config(wl["config"]),
                      cat.traffic(wl["traffic"]), cat.cell(name), seed=SEED,
                      seconds=0, trace=False, device="cpu", guard=False)
    run.setup()
    run.free_program()
    ref = run.reference()
    ok, chk = checks.judge(checks.values(run.reference(lowp=True), ref),
                           run.cell["limits"])
    assert not ok, chk


@pytest.mark.parametrize("fault", [StateUnchanged, HalfBatch, ClientLeftOut])
def test_planted_fault_is_not_correct(toys, fault):
    res = _execute(toys, "vit_toy.muon_toy", plant=fault())
    assert not res["correct"], res["checks"]


@pytest.mark.parametrize("fault", [StateUnchanged, HalfBatch, ClientLeftOut])
def test_planted_fault_in_soap_is_not_correct(toys, fault):
    res = _execute(toys, "lm_toy.soap_toy", plant=fault())
    assert not res["correct"], res["checks"]
