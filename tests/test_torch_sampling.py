"""Port ≡ reference for the sampling API's small parts: the support
matrix (`sampling.supported`) and `Sampler.sample_stacked` of the
one-device backends, each against live `repro` on the same graph and
indices (the mesh samplers' override is held in the 2×2 world of
`test_torch_mesh_frontend.py`).  Tolerance: exact (integer masks)."""
import functools

import numpy as np
import pytest
import torch

from repro import sampling as jsampling
from repro.graph import csr as jcsr
from repro.graph import generators as jgen
from repro_torch import convert
from repro_torch import sampling as tsampling
from repro_torch.graph import csr as tcsr
from repro_torch.graph import generators as tgen

torch.set_num_threads(1)

GRAPH = dict(n=150, avg_deg=5.0, prob=0.25, seed=17)
INDICES = [0, 2, 5]


@functools.lru_cache(maxsize=None)
def _graphs():
    return (jcsr.dedupe(jgen.powerlaw_cluster(**GRAPH)),
            tcsr.dedupe(tgen.powerlaw_cluster(**GRAPH, device="cpu")))


def test_supported_matches_the_reference():
    assert tsampling.spec._SUPPORTED == jsampling.spec._SUPPORTED
    for diffusion in tsampling.DIFFUSIONS + ("sir",):
        for backend in tsampling.BACKENDS + ("warp",):
            assert tsampling.supported(diffusion, backend) \
                == jsampling.supported(diffusion, backend), \
                (diffusion, backend)


@pytest.mark.parametrize("diffusion", ["ic", "lt"])
@pytest.mark.parametrize("backend", ["dense", "tiled", "kernel"])
def test_sample_stacked_matches_the_reference(backend, diffusion):
    gj, gt = _graphs()
    kw = dict(backend=backend, diffusion=diffusion, num_colors=64,
              master_seed=9, tile_size=32)
    want = np.asarray(jsampling.make_sampler(
        gj, jsampling.SamplerSpec(**kw)).sample_stacked(INDICES))
    got = tsampling.make_sampler(gt, tsampling.SamplerSpec(**kw)) \
        .sample_stacked(INDICES)
    assert tuple(got.shape) == (len(INDICES), GRAPH["n"], 2)
    np.testing.assert_array_equal(convert.masks_to_numpy(got), want)
