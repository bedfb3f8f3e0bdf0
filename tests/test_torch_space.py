"""The port's copied pure-Python layers against the JAX reference: the
clean knob space (§3.2), the cost model, the samplers and the configs.

These are copies, so every comparison is exact: the same space, pins and
report, the same ``step_s`` to the last bit, the same LHS designs.
"""

import dataclasses

import numpy as np
import pytest

from repro.configs import ARCH_IDS as REF_ARCH_IDS
from repro.configs import get_config as ref_get_config
from repro.core import costmodel as rcm
from repro.core import knobs as rknobs
from repro.core import sampling as rsampling
from repro.models.config import SHAPES_BY_NAME as REF_SHAPES
from repro_torch.configs import ARCH_IDS, get_config, get_smoke_config
from repro_torch.core import costmodel as pcm
from repro_torch.core import knobs as pknobs
from repro_torch.core import sampling as psampling
from repro_torch.core.tuner import expert_manual_config
from repro.core.tuner import expert_manual_config as ref_expert
from repro_torch.models.config import SHAPES_BY_NAME

CELLS = [(a, s) for a in REF_ARCH_IDS for s in REF_SHAPES]


def _plain(obj):
    """Class name + fields, so objects of the two packages compare."""
    if dataclasses.is_dataclass(obj):
        return (type(obj).__name__,
                tuple((f.name, _plain(getattr(obj, f.name)))
                      for f in dataclasses.fields(obj)))
    if isinstance(obj, (tuple, list)):
        return tuple(_plain(o) for o in obj)
    if isinstance(obj, dict):
        return tuple(sorted((k, _plain(v)) for k, v in obj.items()))
    return obj


def test_same_arch_and_shape_registry():
    assert ARCH_IDS == REF_ARCH_IDS
    assert list(SHAPES_BY_NAME) == list(REF_SHAPES)
    for a in ARCH_IDS:
        assert _plain(get_config(a)) == _plain(ref_get_config(a))
        assert _plain(get_smoke_config(a)) == _plain(
            __import__("repro.configs", fromlist=["get_smoke_config"])
            .get_smoke_config(a))


@pytest.mark.parametrize("multi_pod", [False, True],
                         ids=["single_pod", "multi_pod"])
def test_clean_space_and_estimate_match_every_cell(multi_pod):
    pmesh = pcm.MULTI_POD if multi_pod else pcm.SINGLE_POD
    rmesh = rcm.MULTI_POD if multi_pod else rcm.SINGLE_POD
    for arch, shape in CELLS:
        cfg, cell = get_config(arch), SHAPES_BY_NAME[shape]
        rcfg, rcell = ref_get_config(arch), REF_SHAPES[shape]
        space, pins, report = pknobs.clean_space(cfg, cell, pmesh)
        rspace, rpins, rreport = rknobs.clean_space(rcfg, rcell, rmesh)
        assert _plain(space) == _plain(rspace), (arch, shape)
        assert pins == rpins and report == rreport, (arch, shape)
        configs = [space.project(space.default_config())] + \
            psampling.latin_hypercube(space, 4, seed=len(arch))
        for c in configs:
            got = pcm.estimate(cfg, cell, pmesh, c)
            want = rcm.estimate(rcfg, rcell, rmesh, c)
            assert got.step_s == want.step_s, (arch, shape)
            assert _plain(got) == _plain(want)


def test_canonical_cell_is_327_knobs():
    space, _, report = pknobs.clean_space(
        get_config("yi-6b"), SHAPES_BY_NAME["train_4k"], pcm.SINGLE_POD)
    assert len(space) == report["clean"] == 327
    assert report["washed"] == 20


@pytest.mark.parametrize("seed", [0, 3])
def test_samplers_and_expert_config_match(seed):
    space, _, _ = pknobs.clean_space(
        get_config("yi-6b"), SHAPES_BY_NAME["train_4k"], pcm.SINGLE_POD)
    rspace, _, _ = rknobs.clean_space(
        ref_get_config("yi-6b"), REF_SHAPES["train_4k"], rcm.SINGLE_POD)
    assert psampling.latin_hypercube(space, 30, seed=seed) == \
        rsampling.latin_hypercube(rspace, 30, seed=seed)
    assert psampling.random_configs(space, 10, seed=seed) == \
        rsampling.random_configs(rspace, 10, seed=seed)
    u = np.random.default_rng(seed).random((8, len(space)))
    assert space.decode_batch(u) == rspace.decode_batch(u)
    np.testing.assert_array_equal(space.encode_batch(space.decode_batch(u)),
                                  rspace.encode_batch(rspace.decode_batch(u)))
    assert expert_manual_config(space) == ref_expert(rspace)
