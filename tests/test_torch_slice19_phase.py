"""``chip_smoke.py`` phase 29 (slice 19) on the CPU at small sizes: the C++
neighbour lists against the dense ones, SchNet ``ScannedMD`` over the native
lists, ``GNNExplainer`` on phase 10's GCN, the ASE bridge through the
SchNet and HDNNP4th predictors, and ``trace``. On the CPU every kernel
wrapper is counted as the card counts its launches (each phase holds its
launches to the derived counts); ``tests/test_torch_cuda.py`` runs the
phase on the card."""
import os

import pytest

from tests.test_torch_zoo_scripts import counted_kernels  # noqa: F401 (a fixture)


@pytest.fixture(scope="module", autouse=True)
def library():
    from gcnn_keras_tpu_torch import native
    if not native.available():
        pytest.skip("no C++ compiler: the native neighbour list cannot be built")


def test_phase_29_native_lists_and_md_run_on_the_cpu(counted_kernels):  # noqa: F811
    cs = counted_kernels
    cs.phase_native_lists("cpu", sizes=(300,), cell=6)
    paths, recs = cs.phase_native_md("cpu", device="cpu", n_atoms=260)
    evals = cs.NATIVE_MD_SEGMENTS * (cs.NATIVE_MD_STEPS + 1)
    assert paths["native_md"]["sorted_segment_sum"] == 10 * evals
    assert len(recs["sorted_segment_sum"]) == 10 * 2  # a one-step segment: 2 evaluations


def test_phase_29_explainer_runs_on_the_cpu(counted_kernels):  # noqa: F811
    cs = counted_kernels
    paths, recs = cs.phase_explainer("cpu", device="cpu", n_nodes=300, epochs=4)
    launches = paths["gnn_explainer"]["sorted_segment_sum"]
    assert launches > 0 and (launches - 3) % 4 == 0  # the target's forward, then 4 epochs
    assert len(recs["sorted_segment_sum"]) == 3 + (launches - 3) // 4


def test_phase_29_ase_bridge_and_trace_run_on_the_cpu(counted_kernels, tmp_path,  # noqa: F811
                                                      monkeypatch):
    cs = counted_kernels
    monkeypatch.chdir(tmp_path)
    paths, recs = cs.phase_ase_bridge("cpu", device="cpu")
    assert paths["ase_schnet"] == cs.schnet_launches("unfused")
    assert paths["ase_hdnnp4th"] == cs.HDNNP4TH_LAUNCHES
    assert {r["path"] for r in recs["sorted_segment_sum"]} == {"ase_schnet", "ase_hdnnp4th"}
    requests = [None, None, ("seed 2, 4 mols", cs.qm9_like_mols(2, 4))]
    cs.phase_trace("cpu", requests, device="cpu")
    assert not os.listdir(tmp_path)
