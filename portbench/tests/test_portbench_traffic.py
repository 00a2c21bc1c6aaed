"""The general generator: the same seed gives the same scenes, and every
seed gives each stated scene size equally often."""

from __future__ import annotations

import json

import pytest
import torch

from conftest import REPO
from portbench.harness import scenes

MIXES = sorted(p.stem for p in (REPO / "portbench" / "traffic").glob("*.json"))


def _make(mix, seed, n):
    gen = torch.Generator().manual_seed(scenes.sub_seed(seed, 2))
    sizes = scenes.scene_sizes(mix, n, gen)
    xy, mask, scene = scenes.tracks(mix, sizes, gen)
    return sizes, xy, mask, scene, scenes.big_patches(n, mix["max_peds"], sizes, gen)


@pytest.mark.parametrize("name", MIXES)
def test_generator_is_deterministic_per_seed(name):
    mix = json.loads((REPO / "portbench" / "traffic" / f"{name}.json").read_text())
    n = 2 * (mix["peds"][1] - mix["peds"][0] + 1)
    a, b = _make(mix, 2**31 + 7, n), _make(mix, 2**31 + 7, n)
    for x, y in zip(a, b):
        assert torch.equal(x, y)
    c = _make(mix, 5, n)
    assert not torch.equal(a[1], c[1])


@pytest.mark.parametrize("name", MIXES)
def test_every_scene_size_equally_often_and_padding_is_zero(name):
    mix = json.loads((REPO / "portbench" / "traffic" / f"{name}.json").read_text())
    lo, hi = mix["peds"]
    n = 3 * (hi - lo + 1)
    for seed in (1, 99):
        sizes, xy, mask, scene, big = _make(mix, seed, n)
        assert sorted(sizes.tolist()) == sorted(list(range(lo, hi + 1)) * 3)
        assert torch.equal(mask.sum(1), sizes)
        assert (xy[~mask] == 0).all() and (big[~mask] == 0).all()
        assert torch.isfinite(xy).all()
        assert set(scene.tolist()) <= set(range(len(mix["extent_m"])))


def test_uneven_scene_count_is_refused():
    with pytest.raises(ValueError):
        scenes.scene_sizes({"peds": [1, 16]}, 17, torch.Generator())


def test_sub_seeds_take_any_whole_number():
    assert scenes.sub_seed(2**40 + 3, 1) != scenes.sub_seed(2**40 + 3, 2)
    assert 0 <= scenes.sub_seed(-5, 1) < 2**63
