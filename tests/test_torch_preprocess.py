"""The port's host pipeline (models/preprocess.py, native/, dataloader.py)
against the JAX package's, on the same numpy-seeded images.

Tolerance: exact, with one exception. Both PIL paths run the same PIL
calls; both native paths run the same C++ source (the port builds its own
copy with g++ under build/native/), so their crops are equal. The JAX
package builds that library with -march=native, which lets the compiler
fuse multiply-adds; the port builds portable code without it, so float
roundings differ: the area filter's uint8 pixels may differ by one level
(2 of 491,520 values at 752x480, none at 640x480 or 400x400, measured) and
the normalized floats x * (2/255) - 1 by one float32 ulp (1.2e-7) besides.
Dataset listings must name the same files and timestamps under
`dataset.subsample` and `dataset.reverse`.
"""

import numpy as np
import pytest

from mast3r_slam_tpu import config as jax_config
from mast3r_slam_tpu import dataloader as jax_dataloader
from mast3r_slam_tpu.models import preprocess as jax_preprocess
from mast3r_slam_torch import config as torch_config
from mast3r_slam_torch import dataloader, native
from mast3r_slam_torch.models import preprocess

SOURCES = [(480, 640), (480, 752), (400, 400)]  # TUM, EuRoC, a square source


def _image(h, w, seed=0):
    rng = np.random.default_rng(seed)
    yy, xx = np.mgrid[0:h, 0:w]
    smooth = np.stack([127 + 100 * np.sin(xx / 37), 127 + 90 * np.cos(yy / 23),
                       127 + 60 * np.sin((xx + yy) / 51)], axis=-1)
    return np.clip(smooth + rng.normal(0, 20, (h, w, 3)), 0, 255).astype(np.uint8)


def _assert_same(a: dict, b: dict):
    assert set(a) == set(b)
    for key in a:
        assert a[key].dtype == b[key].dtype, key
        np.testing.assert_array_equal(a[key], b[key], err_msg=key)


def _assert_same_native(a: dict, b: dict):
    """The native band of the module docstring."""
    np.testing.assert_array_equal(a["true_shape"], b["true_shape"])
    pa, pb = a["unnormalized_img"].astype(int), b["unnormalized_img"].astype(int)
    assert pa.shape == pb.shape and np.abs(pa - pb).max() <= 1
    assert (pa != pb).mean() <= 1e-5
    same = (pa == pb)[None]
    np.testing.assert_allclose(a["img"][same], b["img"][same], atol=1.2e-7, rtol=0)
    np.testing.assert_allclose(a["img"], b["img"], atol=2 / 255 + 1.2e-7, rtol=0)


@pytest.mark.parametrize("size", [512, 224])
@pytest.mark.parametrize("hw", SOURCES)
def test_resize_img_matches_jax(hw, size):
    img = _image(*hw)
    _assert_same(preprocess.resize_img(img, size), jax_preprocess.resize_img(img, size))
    a, ta = preprocess.resize_img(img, size, return_transformation=True)
    b, tb = jax_preprocess.resize_img(img, size, return_transformation=True)
    _assert_same(a, b)
    assert ta == tb


@pytest.mark.parametrize("hw", SOURCES)
def test_resize_img_native_matches_jax(hw):
    assert native.native_available()
    img = _image(*hw, seed=1)
    out = preprocess.resize_img_native(img, 512)
    _assert_same_native(out, jax_preprocess.resize_img_native(img, 512))
    # the crop is patch-aligned: 640x480 -> 512x384, the card's main path shape
    if hw == (480, 640):
        assert out["unnormalized_img"].shape == (384, 512, 3)


def test_native_library_builds_under_build_dir():
    from mast3r_slam_torch.ops import build

    path = build.build("preprocess")
    assert path.parent == build.BUILD_ROOT / "native" and path.exists()


def _listing(ds) -> tuple:
    names = [p.name for p in getattr(ds, "files")]
    stamps = list(getattr(ds, "stamps", range(len(names))))
    return names, [float(s) for s in stamps]


@pytest.mark.parametrize("subsample,reverse", [(1, False), (2, False), (3, True)])
def test_dataset_listing_matches_jax(tmp_path, subsample, reverse):
    from PIL import Image

    folder = tmp_path / "folder"
    tum = tmp_path / "tum"
    (tum / "rgb").mkdir(parents=True)
    folder.mkdir()
    lines = ["# timestamp filename"]
    for i in range(7):
        img = Image.fromarray(_image(8, 12, seed=i))
        img.save(folder / f"{i:03d}.png")
        img.save(tum / "rgb" / f"{i:03d}.png")
        lines.append(f"{100.0 + 0.5 * i:.6f} rgb/{i:03d}.png")
    (folder / "notes.txt").write_text("not an image")
    (tum / "rgb.txt").write_text("\n".join(lines) + "\n")

    d = {"dataset": {"subsample": subsample, "reverse": reverse}}
    jax_config.set_config(jax_config.Config.from_dict(d))
    torch_config.set_config(torch_config.Config.from_dict(d))
    try:
        for path, kind in ((folder, "FolderDataset"), (tum, "TUMDataset")):
            port, ref = dataloader.load_dataset(path), jax_dataloader.load_dataset(path)
            assert type(port).__name__ == type(ref).__name__ == kind
            assert len(port) == len(ref) == len(range(0, 7, subsample))
            assert _listing(port) == _listing(ref)
            ts, rgb = port[0]
            ts_ref, rgb_ref = ref[0]
            assert ts == ts_ref
            np.testing.assert_array_equal(rgb, rgb_ref)
    finally:
        torch_config.reset_config()


def test_prefetch_loader_yields_the_native_path():
    class Frames(dataloader.Dataset):
        def __init__(self, imgs):
            self.imgs = imgs

        def __len__(self):
            return len(self.imgs)

        def __getitem__(self, i):
            return float(i), self.imgs[i]

    imgs = [_image(480, 640, seed=s) for s in range(3)]
    got = list(dataloader.PrefetchLoader(Frames(imgs), img_size=512)(max_frames=2))
    assert [ts for ts, _ in got] == [0.0, 1.0]
    for (_, out), img in zip(got, imgs):
        _assert_same(out, preprocess.resize_img_native(img, 512))
