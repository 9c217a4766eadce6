"""``chip_smoke.py`` phase 30 (slice 20) on the CPU at small sizes, 2 gloo
ranks: the data-parallel steps of ``schnet_train`` and ``hdnnp4th_train``
against the single-rank mean, the partitioned SchNet on a 3000-node chain
against its oracle, replica MD against one device, and ``train_force
--distributed`` as 2 ranks joined from a launcher's variables against the
CPU. Every kernel wrapper is counted as the card counts its launches, in
this process (``counted_kernels``) and in each rank
(``chip_smoke.count_kernels_on_cpu``); ``tests/test_torch_cuda.py`` runs the
phase on the card."""
import pytest

from tests.test_torch_zoo_scripts import counted_kernels  # noqa: F401 (a fixture)


@pytest.fixture(scope="module", autouse=True)
def library():
    from gcnn_keras_tpu_torch import native
    if not native.available():
        pytest.skip("no C++ compiler: the chain's native neighbour list cannot be built")


def test_phase_30_runs_on_the_cpu(counted_kernels, tmp_path, monkeypatch):  # noqa: F811
    cs = counted_kernels
    monkeypatch.chdir(tmp_path)
    sizes = {"dp": {"schnet_train": 8, "hdnnp4th_train": 4}, "nodes": 3000, "md": (4, 3, 2)}
    paths, recs = cs.phase_parallel("cpu", device="cpu", sizes=sizes)
    for r in range(cs.PARALLEL_RANKS):
        for path in cs.PARALLEL_DP_PATHS:
            assert paths[f"parallel_{path}_rank{r}"] == {
                k: cs.TRAIN_STEPS * v for k, v in cs.TRAIN_PATHS[path]["launches"].items()}
        assert paths[f"replica_md_rank{r}"]["sorted_segment_sum"] == 2 * 4 * 10
        assert paths[f"partitioned_schnet_rank{r}"]["sorted_segment_sum"] == 3 * 17
        assert paths[f"train_force_distributed_Schnet_rank{r}"]["sorted_segment_sum"] > 0
    paths_by = {r["path"] for r in recs["sorted_segment_sum"]}
    assert paths_by == {"partitioned_schnet_rank0", "train_force_distributed_Schnet"}
    assert not list(tmp_path.iterdir())
