"""One started world carrying several worlds' rank programs, as the GPU
smoke's phase 9d runs its mesh jobs (`launch.accel.start`,
`launch.mesh_smoke.rank_jobs`), on gloo worlds of CPU processes.

* `accel.start` returns at once; `World.join` gives the ranks' results in
  rank order and where the start went (``World.timing``, ordered).
* `comm.Mesh(members=...)`: meshes on some ranks of the group (ascending)
  whose collectives involve those ranks alone, the others standing
  by (``member`` False, ``rank`` None); a mesh over the whole group still
  follows; bad members raise.
* `launch.train.main` called on every rank of a started world (torchrun's
  way) runs its ``--mesh`` there: the same losses, grad norms and per-rank
  numbers as the launcher's own world, bit for bit; a mesh the group
  does not hold raises.
* The smoke's 1x3 job on ranks 0-2 of a world of 4 gives the golden
  ``"mesh"`` entry's (1, 3) cases (its (e)), sha256 and words.
Tolerance: exact everywhere."""
import json
import os

import pytest
import torch

from repro_torch.distributed.comm import Mesh
from repro_torch.launch import accel, mesh_smoke
from repro_torch.launch import train as tlaunch

import torch_mesh_workers as workers

torch.set_num_threads(1)

GOLDEN = os.path.join(os.path.dirname(__file__), "data",
                      "torch_port_golden.json")
ARGV = ["--arch", "llama3.2-3b", "--smoke", "--device", "cpu", "--steps",
        "2", "--mesh", "2x2", "--backend", "gloo", "--timeout-s", "120"]


def test_start_returns_and_join_times_the_start():
    world = accel.start(mesh_smoke.rank_transport_probe, 2,
                        args=([1 << 16],), device="cpu", timeout_s=120)
    ranks = world.join()
    assert [r["rank"] for r in ranks] == [0, 1]
    assert all(r["world"] == 2 and r["sizes"][0]["bytes"] == 1 << 16
               for r in ranks)
    t = world.timing
    assert 0 <= t["enter_s"] <= t["device_s"] <= t["group_s"] \
        <= t["world_s"]
    assert 0 <= t["run_s"] <= t["world_s"]


def test_sub_meshes_of_one_world():
    ranks = accel.spawn(workers.members_world, 4, device="cpu",
                        timeout_s=120)
    for r in ranks:
        q = r["rank"]
        assert r["pair"]["member"] == (q in (1, 3))
        assert r["pair"]["rank"] == {1: 0, 3: 1}.get(q)
        assert r["trio"]["member"] == (q < 3)
        assert r["trio"]["rank"] == (q if q < 3 else None)
        assert r["whole"] == 4.0
        assert r["refused"] == [(2, 1), (0, 0), (0, 4)]
        if q in (1, 3):
            assert r["pair"]["gathered"] == [1.0, 3.0]
            assert r["pair"]["total"] == 4.0
            assert r["pair"]["index"] == {1: 0, 3: 1}[q]
            assert r["pair"]["sent"] == [{1: 3.0, 3: 1.0}[q]]
        if q < 3:
            assert r["trio"]["gathered"] == [0, 1, 2]
            assert r["trio"]["broadcast"] == [10]


@pytest.mark.parametrize("members", [(0, 0), (0, 5), (1, 0)])
def test_bad_members_raise(members):
    with pytest.raises(ValueError, match="members"):
        Mesh((1, 2), ("data", "model"), device="cpu", members=members)


@pytest.fixture(scope="module")
def jobs_world():
    with open(GOLDEN) as f:
        golden = json.load(f)
    jobs = [("train", mesh_smoke.rank_train_launcher, (ARGV,)),
            ("mesh_1x3", mesh_smoke.rank_main_1x3, (golden, (0, 1, 2)))]
    world = accel.start(mesh_smoke.rank_jobs, 4, args=(jobs,),
                        device="cpu", timeout_s=600)
    return golden, world.join()


def test_launcher_in_a_started_world_equals_its_own(jobs_world):
    _, ranks = jobs_world
    own = tlaunch.main(ARGV)
    got = [r["results"]["train"] for r in ranks]
    for key in ("losses", "grad_norms", "rank_losses", "rank_launches",
                "mesh_stats", "staged_bytes"):
        assert got[0][key] == own[key], key
    assert [g["rank"] for g in got] == [0, 1, 2, 3]
    assert all(g["rank_losses"] == own["rank_losses"] for g in got)
    for r in ranks:
        start, end = r["times"]["train"]
        assert start <= end <= r["times"]["mesh_1x3"][0]


def test_one_by_three_job_on_three_of_four_ranks(jobs_world):
    golden, ranks = jobs_world
    got = [r["results"]["mesh_1x3"] for r in ranks]
    assert [g["member"] for g in got] == [True, True, True, False]
    cases = [c for g in got[:3] for c in g["e"]["cases"]]
    want = [c for c in golden["mesh"]["cases"] if c["shape"] == [1, 3]]
    assert len(cases) == 3 * len(want) == 12
    assert all(c["shas_equal"] and c["words_equal"] for c in cases)


def test_launcher_refuses_a_group_of_another_size():
    argv = ARGV[:ARGV.index("--mesh")] + ["--mesh", "1x2", "--backend",
                                          "gloo"]
    with pytest.raises(RuntimeError, match="ValueError"):
        accel.spawn(mesh_smoke.rank_jobs, 4, args=(
            [("train", mesh_smoke.rank_train_launcher, (argv,))],),
            device="cpu", timeout_s=120)
