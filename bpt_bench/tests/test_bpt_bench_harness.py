"""The harness: ``BENCHMARK.json`` and what it names, the imports a run may
make, and whole runs on CPU tensors at small sizes, sound and with the
timed path broken underneath (each must then come out not correct).

The run on the card is the one test that needs it; it decides inside a
fixture whether there is one.
"""
from __future__ import annotations

import ast
import json
import os
import re
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from bpt_bench import spec
from bpt_bench.reference import graphgen, ic
from bpt_bench.run import FORBIDDEN, run_cell

REPO = Path(__file__).resolve().parents[2]
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
BENCH = spec.load_benchmark()
CELLS = [w["name"] for w in BENCH["workloads"]]
ENV = dict(os.environ, PYTHONPATH=f"{REPO / 'src'}:{REPO}")


def test_benchmark_keys_and_limits():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs",
                          "workloads", "end_to_end", "per_layer"}
    assert BENCH["paths"] == ["bpt_bench"]
    assert isinstance(BENCH["run_seconds"], int) \
        and 1 <= BENCH["run_seconds"] <= 51
    for m in BENCH["end_to_end"]:
        assert 0.01 <= m["bound"] <= 0.25
        assert m["source"] in ("host_clock", "device_trace")
    assert any(m["name"] == "setup_s" for m in BENCH["end_to_end"])
    assert sum(w["chips"] == 4 for w in BENCH["workloads"]) <= 1
    assert len(json.dumps(BENCH)) < 64 * 1024


def test_names_and_units_use_the_allowed_characters():
    names = [x["name"] for k in ("configs", "workloads", "end_to_end",
                                 "per_layer") for x in BENCH[k]]
    assert len(names) == len(set(names))
    for w in BENCH["workloads"]:
        names += [w["config"], w["traffic"]]
    for c in BENCH["configs"]:
        names += c["reduced"]
    for n in names:
        assert NAME.match(n), n
    for m in BENCH["end_to_end"] + BENCH["per_layer"]:
        assert UNIT.match(m["unit"]), m["unit"]
        assert m["better"] in ("lower", "higher")


@pytest.mark.parametrize("cell", CELLS)
def test_every_cell_resolves_its_files_by_name(cell):
    w = spec.cell(BENCH, cell)
    conf = next(c for c in BENCH["configs"] if c["name"] == w["config"])
    assert (REPO / conf["file"]).exists()
    config = spec.config(w["config"])
    assert config["name"] == w["config"]
    assert set(conf["reduced"]) <= set(config["reduced"])
    spec.reference(config["reference"])
    loop = spec.loop(spec.traffic(w["traffic"])["loop"])
    for fn in ("setup", "window", "layer_record", "release", "verify"):
        assert callable(getattr(loop, fn))
    e2e = spec.metrics_of(BENCH, cell, "end_to_end")
    assert "setup_s" in {m["name"] for m in e2e} and len(e2e) >= 2
    assert spec.metrics_of(BENCH, cell, "per_layer")
    for m in e2e + spec.metrics_of(BENCH, cell, "per_layer"):
        assert callable(spec.reader(m["name"]))


def test_every_per_layer_metric_moves_a_metric_its_cells_report():
    for m in BENCH["per_layer"]:
        for cell in m.get("workloads", CELLS):
            reported = {e["name"] for e in spec.metrics_of(BENCH, cell,
                                                          "end_to_end")}
            assert m["moves"] in reported, (m["name"], cell)
        assert m["name"].endswith("_roofline") == (m["unit"] == "%"
                                                   and "roofline" in
                                                   m["name"])


def _top_level_modules(code: str) -> set[str]:
    out = subprocess.run([sys.executable, "-c", code + "\nimport sys\n"
                          "print(sorted({m.split('.')[0] for m in "
                          "sys.modules}))"], capture_output=True, text=True,
                         env=ENV, cwd=REPO, timeout=300)
    assert out.returncode == 0, out.stderr
    return set(ast.literal_eval(out.stdout.strip().splitlines()[-1]))


def test_nothing_the_harness_imports_is_jax_or_the_jax_package():
    code = ("import runpy, glob\n"
            "from bpt_bench import run, spec, program, trace, check, work\n"
            "b = spec.load_benchmark()\n"
            "for w in b['workloads']:\n"
            "    spec.loop(spec.traffic(w['traffic'])['loop'])\n"
            "    spec.reference(spec.config(w['config'])['reference'])\n"
            "for m in b['end_to_end'] + b['per_layer']:\n"
            "    spec.reader(m['name'])\n")
    loaded = _top_level_modules(code)
    assert "repro_torch" in loaded
    assert not loaded & set(FORBIDDEN)


def test_no_reference_module_imports_the_program():
    for path in sorted((REPO / "bpt_bench" / "reference").glob("*.py")):
        tree = ast.parse(path.read_text())
        for node in ast.walk(tree):
            names = []
            if isinstance(node, ast.Import):
                names = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom):
                names = [node.module or ""]
            for n in names:
                assert n.split(".")[0] not in ("repro_torch",) + FORBIDDEN, \
                    (path.name, n)
        mod = f"bpt_bench.reference.{path.stem}"
        loaded = _top_level_modules(f"import {mod}")
        assert not loaded & {"repro_torch", *FORBIDDEN}, path.name


def test_run_without_a_card_exits_nonzero_and_prints_no_result():
    out = subprocess.run(
        [sys.executable, "bpt_bench/run.py", "--workload", CELLS[0],
         "--seed", "1", "--seconds", "1", "--trace", "0"],
        capture_output=True, text=True, cwd=REPO, timeout=300,
        env=dict(os.environ, CUDA_VISIBLE_DEVICES=""))
    assert out.returncode != 0
    assert "{" not in out.stdout


# ----------------------------------------------------------- whole runs
SMALL = {"vertices": 600, "arcs_per_vertex": 6.0, "ic_prob": 0.3}
TRAFFIC = {
    "build": {"pool_batches": 4, "check_batches": 3, "trace_from_call": 1,
              "trace_calls": 2},
    "query": {"pool_batches": 3, "check_answers": 40, "check_batches": 2,
              "cache_capacity": 64,
              "trace_from": 0.2, "trace_seconds": 0.3},
}
SEED = 2 ** 31 + 99


def _small_run(cell, trace=False, seconds=1.0):
    w = spec.cell(BENCH, cell)
    config = dict(spec.config(w["config"]), **SMALL)
    traffic = dict(spec.traffic(w["traffic"]), **TRAFFIC[w["traffic"]])
    return run_cell(BENCH, cell, SEED, seconds, trace, [torch.device("cpu")],
                    config=config, traffic=traffic)


@pytest.mark.parametrize("cell", CELLS)
@pytest.mark.parametrize("trace", [False, True])
def test_a_sound_small_run_is_correct(cell, trace):
    out = _small_run(cell, trace)
    assert out["correct"], out["checks"]
    assert list(out)[-1] == "checks"
    assert out["attempted"] > 0 and out["failed"] == 0
    names = {m["name"] for m in spec.metrics_of(
        BENCH, cell, "per_layer" if trace else "end_to_end")}
    assert set(out["metrics"]) <= names
    assert out["device"]["count"] == 1
    if not trace:
        assert "setup_s" in out["metrics"]


def test_the_query_loop_keeps_each_client_one_query_outstanding():
    from bpt_bench.loops import queries
    traffic = spec.traffic("query")
    kinds = queries.clients(traffic)
    assert kinds.count("sigma") == kinds.count("marginal") == 8
    lo, hi = traffic["set_size"]
    a = queries.client_sets(traffic, SEED, 1000, 11, 3)
    b = queries.client_sets(traffic, SEED + 1, 1000, 11, 3)
    for _ in range(3):           # each block asks every size once
        sa = sorted(len(next(a)) for _ in range(hi - lo + 1))
        sb = sorted(len(next(b)) for _ in range(hi - lo + 1))
        assert sa == sb == list(range(lo, hi + 1))
    out = _small_run("ic-livejournal.query")
    assert out["attempted"] % len(kinds) == 0


def _bf16_sample(monkeypatch):
    """The control: the plain sampler in bfloat16 in the sampler's
    place."""
    from repro_torch.core import rrr
    from repro_torch.sampling import sampler as sampler_mod

    def sample(self, batch_index):
        src, dst, prob = self.graph.edges_numpy()
        rev = ic.reverse(graphgen.Edges(src, dst, prob,
                                        self.graph.num_vertices), "cpu")
        mask = ic.sample(rev, self.spec.master_seed, batch_index,
                         self.spec.num_colors, prob_dtype=torch.bfloat16)
        return rrr.RRRBatch(ic.pack(mask), self.batch_starts(batch_index),
                            int(batch_index), -1, -1)

    monkeypatch.setattr(sampler_mod.TiledSampler, "sample", sample)


def _unchanged_refresh(monkeypatch):
    """A refresh that returns its slots and leaves the pool as it was."""
    from repro_torch.serve.influence import sketch_store

    def refresh(self, fraction=0.25):
        count = max(1, int(np.ceil(fraction * len(self.batches))))
        return list(range(count))

    monkeypatch.setattr(sketch_store.SketchStore, "refresh", refresh)


def _half_colours(monkeypatch):
    """Half of each batch's colours left out of the traversal."""
    from repro_torch.core import rrr
    from repro_torch.sampling import sampler as sampler_mod
    real = sampler_mod.TiledSampler.sample

    def sample(self, batch_index):
        b = real(self, batch_index)
        vis = b.visited.clone()
        vis[:, vis.shape[1] // 2:] = 0
        return rrr.RRRBatch(vis, b.roots, b.batch_index, -1, -1)

    monkeypatch.setattr(sampler_mod.TiledSampler, "sample", sample)


def _altered_level(monkeypatch):
    """One bit of every level's new frontier altered where the kernel
    writes it."""
    from repro_torch.kernels import ops
    real = ops.fused_expand

    def fused_expand(*a, **k):
        out = real(*a, **k).clone()
        out[1, 0] ^= 1
        return out

    monkeypatch.setattr(ops, "fused_expand", fused_expand)


def _stale_answers(monkeypatch):
    """The engine hands back its first marginal answer every time."""
    from repro_torch.serve.influence import engine
    real = engine.QueryEngine.marginal_padded
    memo = {}

    def marginal_padded(self, seeds, mask):
        if "first" not in memo:
            memo["first"] = real(self, seeds, mask)
        return memo["first"]

    monkeypatch.setattr(engine.QueryEngine, "marginal_padded",
                        marginal_padded)


def _half_pool(monkeypatch):
    """Coverage over half the pool's batches, doubled."""
    from repro_torch.kernels import ops
    real = ops.cover_counts_multi

    def cover_counts_multi(visited, active):
        half = max(1, visited.shape[0] // 2)
        return real(visited[:half], active[:half]) * 2

    monkeypatch.setattr(ops, "cover_counts_multi", cover_counts_multi)


def _stale_stack(monkeypatch):
    """The pool's stacked masks hold the first batch in every row."""
    from repro_torch.core import rrr

    def stack_visited(batches):
        return torch.stack([batches[0].visited] * len(batches))

    monkeypatch.setattr(rrr, "stack_visited", stack_visited)


def _altered_answer(monkeypatch):
    """One count of each marginal dispatch's first slot altered."""
    from repro_torch.serve.influence import engine
    real = engine.QueryEngine.marginal_padded

    def marginal_padded(self, seeds, mask):
        out = np.array(real(self, seeds, mask))
        out[0, 0] += self._n / self._theta
        return out

    monkeypatch.setattr(engine.QueryEngine, "marginal_padded",
                        marginal_padded)


FAULTS = {
    "build": {"control_bfloat16": _bf16_sample,
              "state_unchanged": _unchanged_refresh,
              "half_the_batch": _half_colours,
              "altered_where_produced": _altered_level},
    "query": {"control_bfloat16": _bf16_sample,
              "state_unchanged": _stale_answers,
              "half_the_batch": _half_pool,
              "altered_where_produced": _altered_answer,
              "stacked_pool_stale": _stale_stack},
}
CASES = [(cell, fault) for cell in CELLS
         for fault in FAULTS[spec.cell(BENCH, cell)["traffic"]]]


@pytest.mark.parametrize("cell,fault", CASES)
def test_a_broken_timed_path_is_not_correct(cell, fault, monkeypatch):
    FAULTS[spec.cell(BENCH, cell)["traffic"]][fault](monkeypatch)
    out = _small_run(cell)
    assert not out["correct"], out["checks"]


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda", 0)


@pytest.mark.cuda
@pytest.mark.parametrize("cell", CELLS)
def test_each_cell_runs_correct_on_the_card(cell, card):
    out = subprocess.run(
        [sys.executable, "bpt_bench/run.py", "--workload", cell, "--seed",
         "2147483711", "--seconds", "2", "--trace", "0"],
        capture_output=True, text=True, cwd=REPO, timeout=600)
    assert out.returncode == 0, out.stderr[-2000:]
    assert json.loads(out.stdout.strip().splitlines()[-1])["correct"]
