"""Port ≡ reference for the fault-tolerant sampling driver
(``tests/test_fault_tolerance.py``'s driver contracts): whatever fails,
straggles or however many workers run, the batches equal the reference's
serial batches bit for bit.  Only results are asserted, never a count or a
time that depends on the clock."""
import sys

import numpy as np
import pytest
import torch

from repro.core import rrr as jrrr
from repro.graph import csr as jcsr
from repro.graph import generators as jgen
from repro_torch import convert
from repro_torch.core.driver import InjectedFailure, SamplingDriver
from repro_torch.graph import csr as tcsr
from repro_torch.graph import generators as tgen
from repro_torch.sampling import SamplerSpec

# pytest-xdist runs several workers on the machine's cores; one intra-op
# thread each keeps torch's many small CPU ops from oversubscribing them.
torch.set_num_threads(1)


@pytest.fixture(scope="module")
def graphs():
    gj = jcsr.dedupe(jgen.powerlaw_cluster(300, 6.0, prob=0.3, seed=4))
    gt = tcsr.dedupe(tgen.powerlaw_cluster(300, 6.0, prob=0.3, seed=4,
                                           device="cpu"))
    return jcsr.transpose(gj), tcsr.transpose(gt)


@pytest.fixture(scope="module")
def reference(graphs):
    """The reference's serial batches 0-7 under master seeds 5 and 9."""
    gj, _ = graphs
    return {seed: [np.asarray(jrrr.sample_batch(gj, 32, seed, b).visited)
                   for b in range(8)] for seed in (5, 9)}


def _assert_batches(batches, want):
    assert [b.batch_index for b in batches] == list(range(len(batches)))
    for got, ref in zip(batches, want):
        np.testing.assert_array_equal(convert.masks_to_numpy(got.visited),
                                      ref)


@pytest.mark.parametrize("backend", ["dense", "kernel"])
def test_driver_no_faults_matches_serial(graphs, reference, backend):
    drv = SamplingDriver(graphs[1], 32, master_seed=5, num_workers=4,
                         spec=SamplerSpec(backend=backend, num_colors=32,
                                          master_seed=5))
    batches = drv.run(8)
    _assert_batches(batches, reference[5])
    assert drv.stats.completed == 8


@pytest.mark.parametrize("backend", ["dense", "kernel"])
def test_driver_survives_failures(graphs, reference, backend):
    """30% injected failures: every batch completes, bit-identical to the
    failure-free run (idempotence).  The injection is a pure function of
    (batch, attempt), so some failure and its reissue always happen."""
    drv = SamplingDriver(graphs[1], 32, master_seed=5, num_workers=4,
                         failure_rate=0.3, max_attempts=20,
                         spec=SamplerSpec(backend=backend, num_colors=32,
                                          master_seed=5))
    batches = drv.run(8)
    assert drv.stats.failures > 0 and drv.stats.reissues > 0
    _assert_batches(batches, reference[5])


def test_driver_handles_stragglers(graphs, reference):
    drv = SamplingDriver(graphs[1], 32, master_seed=5, num_workers=4,
                         slow_rate=0.3, slow_s=0.2)
    _assert_batches(drv.run(8), reference[5])


@pytest.mark.parametrize("workers", [1, 3, 8])
def test_driver_elastic_worker_counts(graphs, reference, workers):
    """Same results regardless of pool size (the elastic-scaling contract),
    and equal to the reference's."""
    batches = SamplingDriver(graphs[1], 32, master_seed=9,
                             num_workers=workers).run(4)
    _assert_batches(batches, reference[9][:4])


def test_driver_stress_many_workers_fast_switching(graphs, reference):
    """More worker threads than cores, switching every microsecond, with
    failures and speculative reissues racing: every batch still equals the
    reference's, each completed once."""
    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        drv = SamplingDriver(graphs[1], 32, master_seed=5, num_workers=16,
                             failure_rate=0.3, max_attempts=40)
        batches = drv.run(8)
    finally:
        sys.setswitchinterval(old)
    _assert_batches(batches, reference[5])
    assert drv.stats.completed == 8


def test_driver_injection_is_deterministic(graphs):
    """Fault injection is keyed by (batch, attempt): the same key fails or
    passes the same way on every driver."""
    a = SamplingDriver(graphs[1], 32, 5, failure_rate=0.5)
    b = SamplingDriver(graphs[1], 32, 5, failure_rate=0.5)

    def outcome(drv, batch, attempt):
        try:
            drv._inject(batch, attempt)
            return True
        except InjectedFailure:
            return False

    keys = [(i, j) for i in range(16) for j in range(1, 4)]
    assert [outcome(a, *k) for k in keys] == [outcome(b, *k) for k in keys]
    assert 0 < a.stats.failures < len(keys)


def test_driver_refuses_mesh_backends_and_spec_conflicts(graphs):
    with pytest.raises(ValueError, match="mesh"):
        SamplingDriver(graphs[1], 32, 5,
                       spec=SamplerSpec(backend="data_parallel",
                                        num_colors=32, master_seed=5))
    with pytest.raises(ValueError, match="conflicts"):
        SamplingDriver(graphs[1], 32, 5,
                       spec=SamplerSpec(num_colors=64, master_seed=5))
