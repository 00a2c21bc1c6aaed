"""The port's real-dataset ingestion against the JAX package, on the CPU.

The same files, written by these tests into a temporary directory in the
reference release layout, go through ``mggan_tpu.data.parsing`` and
``mggan_tpu_torch.data.parsing``: windows, scene names, ped ids,
trajectories (NaN where a future is inactive), every image-pyramid level,
the big patches, ``format`` and ``px_per_meter`` must be equal. The port's
``resize_area`` is held to ``cv2.resize(INTER_AREA)`` byte for byte (no
pixel allowance), its table reader to pandas, and its native host ops to
the JAX package's and to their own numpy versions.
"""

import json
import subprocess
import sys
from pathlib import Path

import cv2
import numpy as np
import pandas as pd
import pytest

from mggan_tpu import native as jax_native
from mggan_tpu.data import homography as jax_homography
from mggan_tpu.data import loaders as jax_loaders
from mggan_tpu.data import parsing as jax_parsing
from mggan_tpu.data import registry as jax_registry
from mggan_tpu_torch import native
from mggan_tpu_torch.config import OBS_LEN
from mggan_tpu_torch.data import homography, image_io, loaders, parsing, registry, table

ROOT = Path(__file__).resolve().parents[1]
PHASES = ("train", "val", "test")


def _jpg(path, h, w, seed):
    """A scene image with texture, so patches and resizes carry signal."""
    rng = np.random.RandomState(seed)
    yy, xx = np.mgrid[0:h, 0:w]
    img = np.stack([(xx * 3) % 256, (yy * 5) % 256, rng.randint(0, 256, (h, w))], -1)
    cv2.imwrite(str(path), img.astype(np.uint8))


def _write_fixtures(root: Path):
    rng = np.random.RandomState(0)
    # BIWI (eth): frame, ID, y, x in metres; ped 3 enters late; an -op image
    for phase in PHASES:
        d = root / "eth" / phase
        d.mkdir(parents=True)
        rows = []
        for f in range(40):
            for p in range(4):
                if p == 3 and f < 7:
                    continue
                x, y = 2 + p + 0.3 * f + rng.rand() * 0.1, 3 + 0.2 * f
                rows.append(f"{float(f)}\t{float(p)}\t{y}\t{x}")
        (d / f"{phase}_eth.txt").write_text("\n".join(rows))
        _jpg(d / "eth.jpg", 64, 96, 1)
        _jpg(d / "eth-op.jpg", 10, 10, 2)
    # SDD: 12 columns, Biker and lost rows filtered out, 30 fps, H_SDD.txt
    (root / "stanford").mkdir()
    (root / "stanford" / "H_SDD.txt").write_text(
        "File\tVersion\tRatio\nsc0.jpg\tA\t0.04\nsc0.jpg\tB\t0.5\nsc1.jpg\tA\t0.07\n")
    for pi, phase in enumerate(PHASES):
        d = root / "stanford" / phase
        d.mkdir()
        for scene, side in (("sc0", 400), ("sc1", 150)):
            rows = []
            for f in range(0, 12 * 27, 12):
                for p in range(3):
                    x = 100 + p * 40 + f * (0.02 + 0.01 * pi) + rng.rand()
                    y = 100 + f * 0.02 + rng.rand()
                    rows.append(f"{p}\t0\t0\t0\t0\t{f}\t0\t0\t0\tPedestrian\t{x}\t{y}")
                    rows.append(f"{90 + p}\t0\t0\t0\t0\t{f}\t0\t0\t0\tBiker\t{x}\t{y}")
                    rows.append(f"{50 + p}\t0\t0\t0\t0\t{f}\t1\t0\t0\tPedestrian\t{x}\t{y}")
            (d / f"{phase}_{scene}.txt").write_text("\n".join(rows))
            _jpg(d / f"{scene}.jpg", side, side, 3)
    # GOFP: is_active = 0 rows make NaN futures; the eth ratio upscales the
    # image (0.0667 / 0.05 = 1.33), the zara1 ratio downscales it
    for phase in PHASES:
        d = root / "gofp" / phase
        d.mkdir(parents=True)
        for scene in ("eth", "zara1"):
            rows = []
            for f in range(0, 4 * 26, 4):
                for p in range(3):
                    active = 0 if (p == 2 and f == 4 * 13) else 1
                    rows.append(f"{float(f)}\t{float(p)}\t{60.0 + p * 30 + f * 0.6}\t"
                                f"{80.0 + f * 0.5}\t0\t0\t{p}\t{active}")
            (d / f"{phase}_{scene}.txt").write_text("\n".join(rows))
            _jpg(d / f"{scene}.jpg", 120, 150, 4)
    # stanford_synthetic: no subsampling, the extra "_" column; peds on both
    # sides of y = 16 for the upper / lower split
    for phase in PHASES:
        d = root / "stanford_synthetic" / phase
        d.mkdir(parents=True)
        rows = []
        for f in range(40):
            for p in range(3):
                x, y = 1.0 + p + 0.1 * f, 2.0 + 10 * p + 0.1 * f - (4.0 if f > 30 else 0)
                rows.append(f"{p}\t0\t0\t0\t0\t{f}\t0\t0\t0\tPedestrian\t{x}\t{y}\t0")
        (d / f"{phase}_sc0.txt").write_text("\n".join(rows))
        _jpg(d / "sc0.jpg", 60, 60, 5)
    return root


@pytest.fixture(scope="module")
def data_root(tmp_path_factory):
    return _write_fixtures(tmp_path_factory.mktemp("data"))


def assert_same_dataset(a, b):
    assert len(a) == len(b) and len(a) > 0
    assert a.scene_names == b.scene_names
    assert a.format == b.format and a.px_per_meter == b.px_per_meter
    for x, y in zip(a.trajectories, b.trajectories):
        assert x.dtype == y.dtype
        np.testing.assert_array_equal(x, y)  # NaN-aware
    for x, y in zip(a.ped_ids, b.ped_ids):
        np.testing.assert_array_equal(x, y)
    assert len(a.big_patches) == len(b.big_patches)
    for x, y in zip(a.big_patches, b.big_patches):
        np.testing.assert_array_equal(x, y)
    assert set(a.images) == set(b.images)
    for scene, ea in a.images.items():
        eb = b.images[scene]
        assert (ea["ratio"], ea["scale_factor"], ea["m_per_px"]) == (
            eb["ratio"], eb["scale_factor"], eb["m_per_px"])
        for level in ("scaled", "small", "tiny"):
            np.testing.assert_array_equal(ea[level], eb[level])


@pytest.mark.parametrize("name", ["eth", "stanford", "gofp", "stanford_synthetic"])
def test_load_scene_dataset_matches_jax(data_root, name):
    want = jax_parsing.load_scene_dataset(name, "train", data_root=data_root)
    got = parsing.load_scene_dataset(name, "train", data_root=data_root)
    assert_same_dataset(want, got)
    if name == "gofp":
        assert any(np.isnan(t[:, OBS_LEN:]).any() for t in got.trajectories)
        assert all(np.isfinite(t[:, :OBS_LEN]).all() for t in got.trajectories)
    if name == "eth":
        assert "eth-op" not in got.images
        assert [len(t) for t in got.trajectories] == [3] * 7 + [4] * 13
    with pytest.raises(FileNotFoundError, match="download the reference data release"):
        parsing.load_scene_dataset(name, "train", data_root=data_root / "missing")


@pytest.mark.parametrize("skip,inclusive,seq_len", [(2, True, 20), (3, True, OBS_LEN),
                                                    (2, False, 20)])
def test_window_scene_matches_jax(skip, inclusive, seq_len):
    rng = np.random.RandomState(3)
    rows = []
    for f in list(range(45)) + list(range(47, 70)):  # one frame gap
        for p in range(6):
            if rng.rand() < 0.2:
                continue
            rows.append([f, p, rng.rand() * 10, rng.rand() * 10, float(rng.rand() > 0.05)])
    data = np.asarray(rows, np.float64)
    want = jax_parsing.window_scene(data, skip=skip, seq_len=seq_len, inclusive=inclusive)
    got = parsing.window_scene(data, skip=skip, seq_len=seq_len, inclusive=inclusive)
    assert len(got) == len(want) > 0
    for (xa, ia), (xb, ib) in zip(want, got):
        np.testing.assert_array_equal(ia, ib)
        np.testing.assert_array_equal(xa, xb)


@pytest.mark.parametrize("split", ["upper", "lower"])
def test_filter_split_matches_jax(data_root, split):
    base_a = jax_parsing.load_scene_dataset("stanford_synthetic", "val", data_root=data_root)
    base_b = parsing.load_scene_dataset("stanford_synthetic", "val", data_root=data_root)
    got = parsing.filter_split(base_b, split)
    assert 0 < len(got) <= len(base_b)
    assert_same_dataset(jax_parsing.filter_split(base_a, split), got)
    want_ds = jax_loaders.get_dataset("stanford_synthetic", "val", data_root=data_root,
                                      split=split)
    assert_same_dataset(want_ds, loaders.get_dataset("stanford_synthetic", "val",
                                                     data_root=data_root, split=split))


@pytest.mark.parametrize("op", ["parse_numeric_txt", "extract_patches", "window_presence"])
def test_host_op_matches_jax_native_and_numpy(data_root, op):
    assert jax_native.available()
    rng = np.random.RandomState(7)
    if op == "parse_numeric_txt":
        for path in [data_root / "eth" / "train" / "train_eth.txt",
                     data_root / "gofp" / "train" / "train_zara1.txt"]:
            got = native.parse_numeric_txt(path)
            np.testing.assert_array_equal(got, jax_native.parse_numeric_txt(path))
            np.testing.assert_array_equal(got, native.parse_numeric_txt_reference(path))
        sdd = data_root / "stanford" / "train" / "train_sc0.txt"
        assert native.parse_numeric_txt(sdd) is None
        assert native.parse_numeric_txt_reference(sdd) is None
        assert jax_native.parse_numeric_txt(sdd) is None
    elif op == "extract_patches":
        img = rng.randint(0, 256, (37, 53, 3)).astype(np.uint8)
        centers = np.stack([rng.randint(-30, 85, 50), rng.randint(-30, 70, 50)], 1)
        got = native.extract_patches(img, centers, 24)
        np.testing.assert_array_equal(got, jax_native.extract_patches(img, centers, 24))
        np.testing.assert_array_equal(got, native.extract_patches_reference(img, centers, 24))
    else:
        present = rng.rand(9, 61) > 0.15
        for skip in (1, 3):
            got = native.window_presence(present, 20, skip)
            np.testing.assert_array_equal(got, jax_native.window_presence(present, 20, skip))
            np.testing.assert_array_equal(got, native.window_presence_reference(present, 20,
                                                                                skip))
            assert got.any()


def test_table_reader_matches_pandas(tmp_path):
    path = tmp_path / "rows.txt"
    path.write_text(
        '1\t5\t0\t"Pedestrian"\t1.5\t7\n'
        '2\t6\t1\tBiker\tnan\t8\n'
        '3\t7\t0\t"Ped""x\tquoted"\t2.5e1\t\n'
        '\n'
        '4\t8\t0\tPedestrian\t-3\t9\n'
        '5\t9\t1\tNA\t4\n')
    got = table.read_table(path, "\t", names=list("abcdefg"))
    want = pd.read_csv(path, header=None, delimiter="\t")
    want.columns = list("abcdefg")[: len(want.columns)]
    assert list(got) == list(want.columns)
    for c in want.columns:
        if got[c].dtype == object:  # pandas 3 types strings as str, pandas 2 as object
            assert pd.api.types.is_string_dtype(want[c].dtype), c
            as_str = lambda col: [v if isinstance(v, str) else ("NaN" if pd.isna(v) else v)
                                  for v in col]
            assert as_str(got[c]) == as_str(want[c]), c
        else:
            assert got[c].dtype == want[c].dtype, c
            np.testing.assert_array_equal(got[c], want[c].to_numpy())
        for value in ("Pedestrian", 0, 1):
            np.testing.assert_array_equal(table.equals(got[c], value),
                                          (want[c] == value).to_numpy())
    sdd = registry.get_info("stanford")
    # load_txt's table path on an SDD file equals the JAX package's pandas path
    d = tmp_path / "sdd.txt"
    d.write_text("\n".join(f"{p}\t0\t0\t0\t0\t{f}\t{p % 2}\t0\t0\t"
                           f"{'Pedestrian' if p < 3 else 'Car'}\t{f + p}\t{2 * f}"
                           for f in range(0, 120, 6) for p in range(5)))
    np.testing.assert_array_equal(parsing.load_txt(d, sdd),
                                  jax_parsing.load_txt(d, jax_registry.get_info("stanford")))


def test_registry_and_sdd_ratios_match_jax(data_root):
    assert registry.load_sdd_ratios(data_root, "stanford") == \
        jax_registry.load_sdd_ratios(data_root, "stanford")
    assert registry.GOFP_RATIOS == jax_registry.GOFP_RATIOS
    assert set(registry.REGISTRY) == set(jax_registry.REGISTRY)
    for name, info in registry.REGISTRY.items():
        assert vars(info) == vars(jax_registry.REGISTRY[name]), name
    assert loaders.SCALING_SMALL == jax_loaders.SCALING_SMALL
    assert registry.phase_dir("r", "eth", "val") == jax_registry.phase_dir("r", "eth", "val")


@pytest.mark.parametrize("src_hw,dst_wh", [
    ((576, 720), (360, 288)),  # integer factor 2: the box path
    ((90, 120), (40, 30)),  # integer factor 3
    ((576, 720), (72, 58)),  # fractional: BIWI's 0.1 small level (58 rows)
    ((300, 300), (186, 186)),  # fractional: the GOFP zara1 ratio, 0.62
    ((120, 150), (200, 160)),  # upscale: the GOFP eth ratio, 1.33
    ((64, 96), (50, 120)),  # up on one axis, down on the other
])
def test_resize_area_matches_cv2(src_hw, dst_wh):
    rng = np.random.RandomState(sum(src_hw) + sum(dst_wh))
    img = rng.randint(0, 256, src_hw + (3,)).astype(np.uint8)
    want = cv2.resize(img, dst_wh, interpolation=cv2.INTER_AREA)
    got = image_io.resize_area(img, dst_wh)
    assert got.shape == want.shape
    # no allowance: equal bytes
    assert int((got != want).sum()) == 0
    np.testing.assert_array_equal(image_io.resize_area(img[..., 0], dst_wh), want[..., 0])


def test_homography_round_trips_and_matches_jax():
    rng = np.random.RandomState(0)
    pts = rng.uniform(0, 500, (64, 2))
    for scene in homography.BIWI_HOMOGRAPHY:
        np.testing.assert_array_equal(homography.BIWI_HOMOGRAPHY[scene],
                                      jax_homography.BIWI_HOMOGRAPHY[scene])
        world = homography.pixel_to_world(pts, scene)
        np.testing.assert_array_equal(world, jax_homography.pixel_to_world(pts, scene))
        np.testing.assert_allclose(homography.world_to_pixel(world, scene), pts, atol=1e-6)
    img = rng.randint(0, 256, (20, 30, 3)).astype(np.uint8)
    h = np.array([[1.0, 0.1, 2.0], [0.05, 1.0, -1.0], [1e-4, 0.0, 1.0]])
    np.testing.assert_array_equal(homography.warp_image(img, h, (25, 18)),
                                  jax_homography.warp_image(img, h, (25, 18)))
    np.testing.assert_allclose(homography.warp_image(img, np.eye(3), (30, 20)), img)


def test_dataloader_batch_matches_jax(data_root):
    kw = dict(batch_size=4, data_root=data_root)
    want = next(iter(jax_loaders.get_dataloader("gofp", "test", **kw)))
    got = next(iter(loaders.get_dataloader("gofp", "test", workers=2, device="cpu", **kw)))
    assert set(got) == set(want)
    for k in want:
        np.testing.assert_array_equal(np.asarray(got[k]), np.asarray(want[k]), err_msg=k)


def test_parses_without_pandas_and_names_both_decoders(data_root, tmp_path):
    """With pandas unimportable the SDD fixture parses equal to the JAX
    package's; with cv2 unimportable too (and no card), ``read_rgb``
    raises naming both decoders."""
    out = tmp_path / "sdd.npz"
    code = (
        "import sys, json, numpy as np; sys.modules['pandas'] = None\n"
        "from mggan_tpu_torch.data import image_io, parsing\n"
        f"ds = parsing.load_scene_dataset('stanford', 'train', data_root={str(data_root)!r})\n"
        "np.savez(%r, *ds.trajectories, small=ds.images['sc0']['small'])\n" % str(out) +
        "sys.modules['cv2'] = None\n"
        "try:\n"
        f"    image_io.read_rgb({str(data_root / 'stanford' / 'train' / 'sc0.jpg')!r})\n"
        "except RuntimeError as e:\n"
        "    print(json.dumps(str(e)))\n"
    )
    proc = subprocess.run([sys.executable, "-c", code], cwd=ROOT, capture_output=True,
                          text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr
    msg = json.loads(proc.stdout.strip().splitlines()[-1])
    assert "cv2" in msg and "nvjpeg" in msg
    want = jax_parsing.load_scene_dataset("stanford", "train", data_root=data_root)
    got = np.load(out)
    np.testing.assert_array_equal(got["small"], want.images["sc0"]["small"])
    assert len(got.files) == len(want) + 1
    for i, t in enumerate(want.trajectories):
        np.testing.assert_array_equal(got[f"arr_{i}"], t)
