"""The port's LMDB tools (fudanocr_tpu_torch/data/create_lmdb.py,
data/corpus_recipes.py and the header probe `data/image.image_size`)
against the JAX package's on the same seeded files, on the CPU:

* every pass-through recipe (800k, 90k, ic with and without an image root,
  gt_txt, detection with labels and masks) writes a database whose files
  are byte for byte JAX's, returns the same counts and prints the same
  lines, over corpora holding undersized, empty, truncated, corrupt-bodied,
  progressive, PNG and non-image files;
* `create_recognition_dataset` (arrays in, the port's JPEG encoder) writes
  JAX's keys in JAX's order, its labels and count; its q95 JPEGs are off
  the source pixels by no more than PIL's q95 JPEGs of the same images
  plus PIXEL_MARGIN (mean absolute error per image, over 0-255);
  `create_sr_dataset` writes `create_dataset`'s database, JAX's keys, a
  gray image decoding gray as PIL's does;
* the probe: PIL's size, None where PIL's open fails (a header cut at
  every byte, an empty or text file, a directory), and NotImplementedError
  for a PIL-written GIF, BMP, TIFF or WebP, which JAX keeps; a recipe over
  such a file raises;
* `crop_words` against PIL's crops, `iter_imagedir_with_labelfile` and
  `iter_gt_pairs` against JAX's (decoded arrays equal), and the CLI.
"""

import io
import json
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
from PIL import Image

from fudanocr_tpu.data import corpus_recipes as jcr
from fudanocr_tpu.data import create_lmdb as jcl
from fudanocr_tpu_torch.data import corpus_recipes as pcr
from fudanocr_tpu_torch.data import create_lmdb as pcl
from fudanocr_tpu_torch.data.image import decode_image, image_size
from fudanocr_tpu_torch.data.jpeg import encode_jpeg
from fudanocr_tpu_torch.data.lmdb_dataset import create_dataset
from fudanocr_tpu_torch.data.lmdb_store import LMDBReader
from fudanocr_tpu_torch.data.png import encode_png

ROOT = Path(__file__).resolve().parents[1]
# the port's q95 JPEG may be off the source by this much more than PIL's
# (mean absolute error per image over 0-255; measured on these images:
# the port's minus PIL's -0.17 to +0.025)
PIXEL_MARGIN = 0.1


def _image(rng, h, w, gray=False):
    """A smooth image with a few bars and mild noise (JPEG-like content)."""
    y, x = np.mgrid[:h, :w]
    base = np.stack([(x * 255 // max(w - 1, 1)), (y * 255 // max(h - 1, 1)),
                     ((x + y) * 3) % 256], -1).astype(np.float64)
    for _ in range(3):
        x0 = rng.integers(0, w)
        base[:, x0:x0 + max(w // 10, 1)] = rng.integers(0, 256, 3)
    img = np.clip(base + rng.normal(0, 6, base.shape), 0, 255).astype(
        np.uint8)
    return img[..., 0] if gray else img


def _jpeg_pil(img, **kw):
    buf = io.BytesIO()
    Image.fromarray(img).save(buf, format="JPEG", quality=90, **kw)
    return buf.getvalue()


def _encoded(rng, h, w, kind):
    """Bytes of an image file of one kind: the port's or PIL's JPEG, a
    progressive JPEG, a PNG, or a broken file."""
    img = _image(rng, h, w)
    if kind == "jpeg":
        return encode_jpeg(img, 95)
    if kind == "pil":
        return _jpeg_pil(img)
    if kind == "progressive":
        return _jpeg_pil(img, progressive=True)
    if kind == "png":
        return encode_png(img)
    if kind == "corrupt_body":         # a header PIL reads; the body cut
        data = encode_jpeg(img, 95)
        return data[:len(data) - len(data) // 3]
    if kind == "truncated":            # cut inside the header
        return encode_jpeg(img, 95)[:60]
    if kind == "empty":
        return b""
    return b"not an image\n"


KINDS = ("jpeg", "pil", "progressive", "png", "corrupt_body", "truncated",
         "empty", "text")
OPENS = KINDS[:5]                 # the kinds PIL's lazy open keeps
SIZES = ((31, 100), (30, 100), (31, 99), (64, 256), (63, 300), (70, 255),
         (40, 180), (80, 320))


def _write(path, data):
    os.makedirs(os.path.dirname(path), exist_ok=True)
    with open(path, "wb") as f:
        f.write(data)


@pytest.fixture(scope="module")
def corpora(tmp_path_factory):
    """Seeded corpora in every layout, written once."""
    root = tmp_path_factory.mktemp("corpora")
    rng = np.random.default_rng(26)
    c = {"root": root}
    expect = c["expect"] = {"90k": 0, "800k": 0, "gt_txt": 0, "ic": {},
                            "ic_root": {}, "detection": 4}
    # MJSynth: root/<d1>/<d2>/<n>_<LABEL>_<m>.<ext>, with a dotted and a
    # plain file at the top (skipped) and a nested directory (skipped)
    mj = root / "90k"
    i = 0
    for d1 in ("2", "10", "1", "x.y"):
        for d2 in ("3", "1"):
            for kind in KINDS:
                h, w = SIZES[i % len(SIZES)]
                i += 1
                _write(str(mj / d1 / d2 / f"{i}_Word{i}_{i % 7}.jpg"),
                       _encoded(rng, h, w, kind))
                expect["90k"] += (kind in OPENS and h >= 31 and w >= 100
                                  and "." not in d1)
    (mj / "1" / "3" / "sub_dir_x").mkdir()
    _write(str(mj / "readme.txt"), b"no")
    c["90k"] = mj
    # SynthText 800k: an .odgt of crops in two directories
    lines = []
    for j, kind in enumerate(KINDS * 2):
        h, w = SIZES[(j * 3) % len(SIZES)]
        d = root / "800k" / f"part{j % 2}"
        name = f"crop_{j}.jpg"
        _write(str(d / name), _encoded(rng, h, w, kind))
        expect["800k"] += kind in OPENS and h >= 64 and w >= 256
        lines.append({"im_path": str(d), "im_name": name,
                      "label": f"wörd{j}"})
    c["800k"] = root / "800k.odgt"
    c["800k"].write_text("\n".join(json.dumps(r) for r in lines) + "\n")
    # ICDAR: one manifest routing to ic13/ic15 train/test, a missing file
    lines = []
    for j, kind in enumerate(KINDS + ("jpeg", "png", "missing")):
        path = root / "ic_images" / f"word_{j}.png"
        if kind != "missing":
            _write(str(path), _encoded(rng, 32, 90, kind))
        lines.append({"img_path": f"/elsewhere/{path.name}" if j % 3 == 0
                      else str(path), "img_gt": f"gt{j}",
                      "dataset": ("IC13", "IC15")[j % 2],
                      "type": ("train", "test")[(j // 2) % 2]})
        key = f"{lines[-1]['dataset'].lower()}_{lines[-1]['type']}"
        for name, found in (("ic", j % 3 != 0), ("ic_root", True)):
            if kind in OPENS and found:
                expect[name][key] = expect[name].get(key, 0) + 1
    c["ic"] = root / "ic.odgt"
    c["ic"].write_text("\n".join(json.dumps(r) for r in lines) + "\n")
    c["ic_root"] = root / "ic_images"
    # SVT: gt.txt of `name label` with a one-field line and a missing file
    svt = root / "svt"
    rows = []
    for j, kind in enumerate(KINDS):
        _write(str(svt / f"img_{j}.jpg"), _encoded(rng, 40, 120, kind))
        expect["gt_txt"] += kind in OPENS
        rows.append(f"img_{j}.jpg LABEL{j}  ")
    rows += ["lonely", "img_missing.jpg GONE", ""]
    (svt / "gt.txt").write_text("\n".join(rows))
    c["svt"] = svt
    # detection: images, boxes, labels and two mask files per sample
    det = root / "det"
    c["det"] = {"image_paths": [], "boxes_x": [], "boxes_y": [],
                "labels": [], "region_masks": [], "pixel_masks": []}
    for j in range(6):
        img = det / f"img_{j}.jpg"
        if j != 4:                                # a missing image
            _write(str(img), _encoded(rng, 48, 64, "jpeg"))
        for m in ("region", "pixel"):
            mask = (rng.random((48, 64)) < 0.3).astype(np.uint8) * 255
            _write(str(det / f"{m}_{j}.png"), encode_png(mask[..., None]))
            c["det"][f"{m}_masks"].append(str(det / f"{m}_{j}.png"))
        c["det"]["image_paths"].append(str(img))
        c["det"]["boxes_x"].append("" if j == 2 else f"{j},{j + 9},{j + 3}")
        c["det"]["boxes_y"].append(f"{2 * j},{j + 1},{j + 7}")
        c["det"]["labels"].append(f"text{j}")
    # an image dir with a label file, and gt pairs
    flat = root / "flat"
    label_lines = []
    for j in range(5):
        _write(str(flat / f"f{j}.jpg"), _encoded(rng, 32, 80 + 8 * j,
                                                 ("jpeg", "pil")[j % 2]))
        label_lines.append(f"f{j}.jpg label {j}")
    label_lines += ["", "f_missing.jpg none"]
    (root / "labels.txt").write_text("\n".join(label_lines) + "\n")
    c["flat"] = flat
    gt = root / "gt"
    for j in (3, 1, 2, 0):
        if j != 2:                                 # an image without gt
            (gt / f"f{j}.txt").parent.mkdir(exist_ok=True)
            (gt / f"f{j}.txt").write_text(f"  gt text {j}\n")
    c["gt"] = gt
    return c


def _db_files(path):
    return {p.name: p.read_bytes() for p in sorted(Path(path).iterdir())}


def _both(capsys, jfn, pfn, out, args, **kw):
    """JAX's and the port's recipe into out/jax and out/port: (results,
    printed lines), each side's."""
    res, printed = [], []
    for fn, side in ((jfn, "jax"), (pfn, "port")):
        res.append(fn(*args(str(out / side)), **kw))
        printed.append(capsys.readouterr().out.replace(str(out / side), ""))
    return res, printed


def _assert_same_dbs(a, b):
    fa, fb = _db_files(a), _db_files(b)
    assert fa.keys() == fb.keys() and fa, (fa.keys(), fb.keys())
    for name in fa:
        assert fa[name] == fb[name], name


@pytest.mark.parametrize("recipe", ["800k", "90k", "gt_txt", "ic",
                                    "ic_root", "detection"])
def test_pass_through_recipes_write_jax_bytes(corpora, tmp_path, capsys,
                                              recipe):
    c = corpora
    calls = {
        "800k": (jcr.create_800k, pcr.create_800k,
                 lambda o: (str(c["800k"]), o), {}),
        "90k": (jcr.create_90k, pcr.create_90k,
                lambda o: (str(c["90k"]), o), {}),
        "gt_txt": (jcr.create_gt_txt, pcr.create_gt_txt,
                   lambda o: (str(c["svt"]), o), {}),
        "ic": (jcr.create_ic, pcr.create_ic,
               lambda o: (str(c["ic"]), o), {}),
        "ic_root": (jcr.create_ic, pcr.create_ic,
                    lambda o: (str(c["ic"]), o),
                    {"image_root": str(c["ic_root"])}),
        "detection": (jcr.create_detection, pcr.create_detection,
                      lambda o: (o, c["det"]["image_paths"],
                                 c["det"]["boxes_x"], c["det"]["boxes_y"]),
                      {k: c["det"][k] for k in ("labels", "region_masks",
                                                "pixel_masks")})}
    jfn, pfn, args, kw = calls[recipe]
    (want, got), (jout, pout) = _both(capsys, jfn, pfn, tmp_path, args, **kw)
    # the counts the seeds imply: the files PIL's lazy open keeps (corrupt
    # bodies too) that pass the recipe's size filter and exist
    assert got == want == c["expect"][recipe] and pout == jout
    if isinstance(want, dict):           # one database per routed bucket
        for key in want:
            _assert_same_dbs(tmp_path / "jax" / key, tmp_path / "port" / key)
    else:
        _assert_same_dbs(tmp_path / "jax", tmp_path / "port")


def test_recipe_meets_a_file_the_port_cannot_read(corpora, tmp_path):
    """A PIL-written GIF in an MJSynth tree: JAX keeps it, the port raises
    rather than skip it."""
    root = tmp_path / "90k"
    img = _image(np.random.default_rng(1), 40, 120)
    path = root / "1" / "1" / "5_Gif_1.gif"
    path.parent.mkdir(parents=True)
    Image.fromarray(img).save(path, format="GIF")
    assert jcr.create_90k(str(root), str(tmp_path / "jax")) == 1
    with pytest.raises(NotImplementedError, match="GIF"):
        pcr.create_90k(str(root), str(tmp_path / "port"))


def _header_end(data: bytes) -> int:
    """The bytes PIL's open reads: a JPEG up to its scan header, a PNG up
    to its first IDAT's header."""
    if data[:2] == b"\xff\xd8":
        sos = data.index(b"\xff\xda")
        return sos + 2 + int.from_bytes(data[sos + 2:sos + 4], "big")
    return data.index(b"IDAT") + 4


@pytest.mark.parametrize("kind", ["jpeg", "pil", "progressive", "png",
                                  "pil_png"])
def test_probe_is_pil_at_every_cut(tmp_path, kind):
    """PIL's size where its open succeeds, None where it fails, for the
    whole file and the file cut at every byte up to its header's end."""
    rng = np.random.default_rng(5)
    if kind == "pil_png":
        buf = io.BytesIO()
        Image.fromarray(_image(rng, 33, 71, gray=True)).save(buf, "PNG")
        data = buf.getvalue()
    else:
        data = _encoded(rng, 33, 71, kind)
    path = tmp_path / "f"
    outcomes = set()
    for cut in list(range(_header_end(data) + 2)) + [len(data)]:
        path.write_bytes(data[:cut])
        try:
            want = Image.open(path).size
        except OSError:
            want = None
        assert image_size(str(path)) == want, cut
        outcomes.add(want)
    assert outcomes == {None, (71, 33)}


@pytest.mark.parametrize("fmt", ["GIF", "BMP", "TIFF", "WEBP"])
def test_probe_refuses_what_pil_keeps(tmp_path, fmt):
    path = tmp_path / f"f.{fmt.lower()}"
    Image.fromarray(_image(np.random.default_rng(2), 20, 30)).save(
        path, format=fmt)
    assert jcr._valid_image(str(path)) is not None      # JAX keeps it
    with pytest.raises(NotImplementedError, match=fmt[:3].upper()
                       if fmt != "WEBP" else "WebP"):
        image_size(str(path))


def test_probe_skips_what_pil_skips(tmp_path):
    for name, data in (("empty", b""), ("text", b"hello world\n"),
                       ("short", b"\xff\xd8")):
        (tmp_path / name).write_bytes(data)
    for p in ("empty", "text", "short", "missing", "."):
        path = str(tmp_path / p)
        assert jcr._valid_image(path) is None and image_size(path) is None


def test_create_recognition_dataset_matches_jax(tmp_path):
    rng = np.random.default_rng(7)
    shapes = [(32, 100), (1, 50), (40, 1), (48, 160), (2, 2), (31, 128)]
    samples = [(_image(rng, h, w, gray=(i % 3 == 2)), f"läbel {i}")
               for i, (h, w) in enumerate(shapes)]
    for check in (True, False):
        out = tmp_path / str(check)
        want = jcl.create_recognition_dataset(
            str(out / "jax"), ((Image.fromarray(a), t) for a, t in samples),
            check_valid=check)
        got = pcl.create_recognition_dataset(str(out / "port"), samples,
                                             check_valid=check)
        assert got == want == (4 if check else 6)
        with LMDBReader(str(out / "jax")) as jr, \
                LMDBReader(str(out / "port")) as pr:
            jkeys, pkeys = ([k for k, _ in r.items()] for r in (jr, pr))
            assert pkeys == jkeys
            kept = [s for s in samples if not check
                    or min(s[0].shape[:2]) >= 2]
            for n, (img, label) in enumerate(kept, 1):
                for r in (jr, pr):
                    assert r.get(b"label-%09d" % n) == label.encode()
                src = pcl.as_rgb(img).astype(np.float64)
                err = [np.abs(decode_image(r.get(b"image-%09d" % n)) - src)
                       .mean() for r in (jr, pr)]
                assert err[1] <= err[0] + PIXEL_MARGIN, (n, err)
            assert pr.get(b"num-samples") == str(got).encode()


def test_create_sr_dataset_is_create_dataset(tmp_path):
    rng = np.random.default_rng(8)
    triples = [(_image(rng, 32, 128), _image(rng, 16, 64), "ab"),
               (_image(rng, 32, 128, gray=True), None, "cd")]
    assert pcl.create_sr_dataset(str(tmp_path / "a"), triples) == 2
    create_dataset(str(tmp_path / "b"), triples)
    _assert_same_dbs(tmp_path / "a", tmp_path / "b")
    jcl.create_sr_dataset(str(tmp_path / "j"), [
        (Image.fromarray(h), l if l is None else Image.fromarray(l), t)
        for h, l, t in triples])
    with LMDBReader(str(tmp_path / "a")) as p, \
            LMDBReader(str(tmp_path / "j")) as j:
        assert [k for k, _ in p.items()] == [k for k, _ in j.items()]
        for r in (p, j):             # one JPEG component: gray stays gray
            gray = r.get(b"image_hr-%09d" % 2)
            assert Image.open(io.BytesIO(gray)).mode == "L"


def test_iterators_match_jax(corpora):
    c = corpora
    for jit, pit in (
            (jcl.iter_imagedir_with_labelfile(str(c["flat"]), str(
                c["root"] / "labels.txt")),
             pcl.iter_imagedir_with_labelfile(str(c["flat"]), str(
                 c["root"] / "labels.txt"))),
            (jcl.iter_gt_pairs(str(c["flat"]), str(c["gt"])),
             pcl.iter_gt_pairs(str(c["flat"]), str(c["gt"])))):
        want, got = list(jit), list(pit)
        assert [t for _, t in got] == [t for _, t in want] and got
        for (a, _), (b, _) in zip(got, want):
            np.testing.assert_array_equal(a, np.asarray(b.convert("RGB")))


def test_crop_words_match_pil():
    rng = np.random.default_rng(9)
    img = _image(rng, 60, 90)
    polys = [[(10.2, 5.7), (40.9, 5.1), (40.1, 20.0), (10.0, 20.5)],
             [(-5.5, -3.0), (12.0, -1.0), (11.5, 8.2)],        # clamped
             [(80.5, 50.5), (95.0, 58.0), (99.9, 70.0)],       # clamped
             [(30.0, 30.0), (30.0, 40.0)],                     # empty
             [(100.0, 10.0), (120.0, 30.0)]]                   # outside
    want = jcr.crop_words(Image.fromarray(img), polys)
    got = pcr.crop_words(img, polys)
    assert len(got) == len(want) == 3
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, np.asarray(w))


def test_cli_runs_a_recipe(corpora, tmp_path, capsys):
    out = subprocess.run(
        [sys.executable, "-m", "fudanocr_tpu_torch.data.corpus_recipes",
         "gt_txt", str(corpora["svt"]), str(tmp_path / "port")],
        cwd=str(ROOT), capture_output=True, text=True, check=True).stdout
    jcr.main(["gt_txt", str(corpora["svt"]), str(tmp_path / "jax")])
    want = capsys.readouterr().out
    assert out.replace(str(tmp_path / "port"), "") == \
        want.replace(str(tmp_path / "jax"), "")
    _assert_same_dbs(tmp_path / "jax", tmp_path / "port")
