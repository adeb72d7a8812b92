"""The port's real datasets (``data/datasets.py``: VOC, Cityscapes, the split
files) and its loader's process slices (``data/pipeline.py``) against the
JAX package's, on fabricated VOC and Cityscapes trees in the reference
layouts (written with PIL, as tests/test_datasets.py does).  Everything is
compared byte for byte: ids, splits, canvases, sizes, and the batches of
the first two epochs of ``Loader`` and ``DualLoader`` for one seed.  The
process slices follow tests/test_multihost_loader.py: the row blocks of
``process_count = 2`` reassemble the global batch, blank pad slots
included."""

from __future__ import annotations

import os

import numpy as np
import pytest
from PIL import Image

from semi_supervised_semantic_segmentation_tpu import config as jconfig
from semi_supervised_semantic_segmentation_tpu.data import datasets as jdatasets
from semi_supervised_semantic_segmentation_tpu.data import pipeline as jpipeline
from semi_supervised_semantic_segmentation_tpu_torch import config
from semi_supervised_semantic_segmentation_tpu_torch.data import datasets, pipeline

VOC_IDS = [f"2007_{i:06d}" for i in range(10)]
VOC_VAL_IDS = [f"2008_{i:06d}" for i in range(3)]
# varied sizes; the last is taller than the 512 canvas (comes back cropped)
_VOC_SIZES = [(60, 80), (45, 37), (64, 64), (33, 90), (72, 41), (50, 50), (81, 62), (40, 44),
              (52, 70), (530, 48)]
CITY_TRAIN = ["aachen/aachen_000000_000019", "aachen/aachen_000001_000019",
              "aachen/aachen_000002_000019", "bochum/bochum_000000_000313",
              "bochum/bochum_000001_000313", "bremen/bremen_000000_000019",
              "bremen/bremen_000001_000019", "bremen/bremen_000002_000019"]
CITY_VAL = ["frankfurt/frankfurt_000000_000294", "lindau/lindau_000000_000019"]
CITY_HW = (40, 72)


def _write_voc_sample(root, sid, h, w, seed, with_label=True):
    rng = np.random.RandomState(seed)
    Image.fromarray((rng.rand(h, w, 3) * 255).astype(np.uint8)).save(
        os.path.join(root, "JPEGImages", sid + ".jpg"), quality=95)
    if with_label:
        lab = rng.randint(0, 21, (h, w)).astype(np.uint8)
        lab[: h // 8] = 255
        im = Image.fromarray(lab, mode="P")
        im.putpalette([c for i in range(256) for c in (i, i // 2, i % 7)])
        im.save(os.path.join(root, "SegmentationClassAug", sid + ".png"))


@pytest.fixture(scope="module")
def voc_root(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("voc"))
    for d in ("JPEGImages", "SegmentationClassAug", "SegmentationClass",
              "ImageSets/Segmentation", "splits/1_4", "splits/1_8"):
        os.makedirs(os.path.join(root, d), exist_ok=True)
    for i, (sid, (h, w)) in enumerate(zip(VOC_IDS, _VOC_SIZES)):
        _write_voc_sample(root, sid, h, w, seed=100 + i)
    for i, sid in enumerate(VOC_VAL_IDS):
        _write_voc_sample(root, sid, 48 + i, 52, seed=900 + i)
    # one val label only under SegmentationClass (the second place searched)
    os.replace(os.path.join(root, "SegmentationClassAug", VOC_VAL_IDS[1] + ".png"),
               os.path.join(root, "SegmentationClass", VOC_VAL_IDS[1] + ".png"))
    seg = os.path.join(root, "ImageSets", "Segmentation")
    with open(os.path.join(seg, "trainaug.txt"), "w") as f:  # two columns
        for sid in VOC_IDS:
            f.write(f"/JPEGImages/{sid}.jpg /SegmentationClassAug/{sid}.png\n")
    with open(os.path.join(seg, "val.txt"), "w") as f:
        f.write("\n".join(VOC_VAL_IDS) + "\n")
    # 1_4: labeled.txt only (the complement is unlabeled); 1_8: both files
    with open(os.path.join(root, "splits", "1_4", "labeled.txt"), "w") as f:
        f.write("\n".join(VOC_IDS[1:4]) + "\n")
    with open(os.path.join(root, "splits", "1_8", "labeled.txt"), "w") as f:
        f.write("\n".join([VOC_IDS[9], VOC_IDS[0]]) + "\n")
    with open(os.path.join(root, "splits", "1_8", "unlabeled.txt"), "w") as f:
        f.write("\n".join(VOC_IDS[4:9]) + "\n\n")
    return root


def _write_city_sample(root, image_set, sid, seed, label_kind):
    h, w = CITY_HW
    city = sid.split("/")[0]
    for top in ("leftImg8bit", "gtFine"):
        os.makedirs(os.path.join(root, top, image_set, city), exist_ok=True)
    rng = np.random.RandomState(seed)
    Image.fromarray((rng.rand(h, w, 3) * 255).astype(np.uint8)).save(
        os.path.join(root, "leftImg8bit", image_set, sid + "_leftImg8bit.png"))
    gt = os.path.join(root, "gtFine", image_set, sid)
    if label_kind == "trainids":
        lab = rng.randint(0, 19, (h, w)).astype(np.uint8)
        lab[:4] = 255
        Image.fromarray(lab, mode="L").save(gt + "_gtFine_labelTrainIds.png")
    else:  # raw label ids only: the fallback through the table
        lab = rng.choice([0, 1, 7, 8, 11, 13, 26, 33], (h, w)).astype(np.uint8)
        Image.fromarray(lab, mode="L").save(gt + "_gtFine_labelIds.png")


@pytest.fixture(scope="module")
def city_root(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("cityscapes"))
    for i, sid in enumerate(CITY_TRAIN):
        _write_city_sample(root, "train", sid, 100 + i,
                           "labelids" if sid.startswith("bochum") else "trainids")
    for i, sid in enumerate(CITY_VAL):
        _write_city_sample(root, "val", sid, 700 + i, "trainids")
    # a stray file in a city directory is not an image id
    open(os.path.join(root, "leftImg8bit", "train", "aachen", "notes.txt"), "w").close()
    return root


def _cfgs(dataset, root, split, **data):
    raw = {"data": {"dataset": dataset, "data_root": root, "split": split,
                    "num_classes": 21 if dataset == "voc" else 19, "crop_size": 64,
                    "num_workers": 2, **data}}
    return jconfig.config_from_dict(raw), config.config_from_dict(raw)


ROLES = ("labeled", "unlabeled", "val")


def test_list_ids_match_the_reference(voc_root, city_root):
    for image_set in ("train", "val"):
        assert datasets.VOCDataset.list_ids(voc_root, image_set) == \
            jdatasets.VOCDataset.list_ids(voc_root, image_set)
        assert datasets.CityscapesDataset.list_ids(city_root, image_set) == \
            jdatasets.CityscapesDataset.list_ids(city_root, image_set)
    assert datasets.VOCDataset.list_ids(voc_root, "train") == VOC_IDS
    assert datasets.CityscapesDataset.list_ids(city_root, "train") == CITY_TRAIN


def test_split_files_and_deterministic_split_match_the_reference(voc_root, city_root):
    all_ids = datasets.VOCDataset.list_ids(voc_root, "train")
    cases = {"1_4": (VOC_IDS[1:4], VOC_IDS[:1] + VOC_IDS[4:]),  # complement
             "1_8": ([VOC_IDS[9], VOC_IDS[0]], VOC_IDS[4:9]),  # both files
             "1_16": None}  # no directory: deterministic
    for split, want in cases.items():
        got = datasets.load_or_make_split(voc_root, all_ids, split)
        assert got == jdatasets.load_or_make_split(voc_root, all_ids, split)
        if want is not None:
            assert got == want
        else:
            assert got == datasets.deterministic_split(all_ids, split)
    city_ids = datasets.CityscapesDataset.list_ids(city_root, "train")
    got = datasets.load_or_make_split(city_root, city_ids, "1_4")
    assert got == jdatasets.deterministic_split(city_ids, "1_4") and len(got[0]) == 2


@pytest.mark.parametrize("dataset,split", [("voc", "1_4"), ("voc", "1_8"), ("voc", "1_16"),
                                           ("cityscapes", "1_4"), ("cityscapes", "full")])
def test_build_dataset_roles_match_the_reference(voc_root, city_root, dataset, split):
    root = voc_root if dataset == "voc" else city_root
    for crop in (64, 608):
        jcfg, cfg = _cfgs(dataset, root, split, crop_size=crop)
        for role in ROLES:
            j, t = jdatasets.build_dataset(jcfg, role), datasets.build_dataset(cfg, role)
            assert type(t).__name__ == type(j).__name__
            assert t.ids == j.ids and len(t) == len(j)
            assert t.canvas_hw == j.canvas_hw and t.labeled == j.labeled
            if dataset == "cityscapes":
                assert t.canvas_hw == (1024, 2048)
                assert t.image_set == j.image_set == ("val" if role == "val" else "train")
            else:
                assert t.canvas_hw == ((max(512, crop),) * 2)


def _slots(ds):
    hc, wc = ds.canvas_hw
    return np.zeros((hc, wc, 3), np.uint8), np.full((hc, wc), 255, np.int32)


@pytest.mark.parametrize("dataset", ["voc", "cityscapes"])
def test_get_into_matches_the_reference_byte_for_byte(voc_root, city_root, dataset):
    root = voc_root if dataset == "voc" else city_root
    jcfg, cfg = _cfgs(dataset, root, "1_4")
    for role in ROLES:
        j, t = jdatasets.build_dataset(jcfg, role), datasets.build_dataset(cfg, role)
        for i in range(len(t)):
            ji, jl = _slots(j)
            ti, tl = _slots(t)
            assert t.get_into(i, ti, tl) == j.get_into(i, ji, jl)
            np.testing.assert_array_equal(ti, ji)
            np.testing.assert_array_equal(tl, jl)
            if role == "unlabeled":
                assert (tl == 255).all()
            else:
                assert (tl != 255).any()


def test_get_returns_the_canvas_view(voc_root):
    """``get`` is the reference's for an image that fits the canvas, and
    the canvas-cropped image with its clipped size for one that does not."""
    jcfg, cfg = _cfgs("voc", voc_root, "1_16")
    j, t = jdatasets.VOCDataset(voc_root, VOC_IDS), datasets.VOCDataset(voc_root, VOC_IDS)
    for i, (h, w) in enumerate(_VOC_SIZES):
        s, js = t.get(i), j.get(i)
        assert s.sample_id == js.sample_id
        if h <= 512:
            assert s.size == js.size == (h, w)
            np.testing.assert_array_equal(s.image, js.image)
            np.testing.assert_array_equal(s.label, js.label)
        else:
            assert s.size == (512, w) and js.size == (h, w)
            np.testing.assert_array_equal(s.image, js.image[:512])
            np.testing.assert_array_equal(s.label, js.label[:512])
    unlab = datasets.VOCDataset(voc_root, VOC_IDS, labeled=False).get(0)
    assert unlab.size == _VOC_SIZES[0] and (unlab.label == 255).all()


def test_cityscapes_label_ids_fall_back_through_the_table(city_root):
    ds = datasets.CityscapesDataset(city_root, CITY_TRAIN)
    h, w = CITY_HW
    for i, sid in enumerate(CITY_TRAIN):
        gt = os.path.join(city_root, "gtFine", "train", sid)
        s = ds.get(i)
        assert s.size == (h, w)
        if sid.startswith("bochum"):
            assert not os.path.exists(gt + "_gtFine_labelTrainIds.png")
            raw = np.asarray(Image.open(gt + "_gtFine_labelIds.png"), np.int32)
            want = np.full_like(raw, 255)
            for train_id, label_id in enumerate([7, 8, 11, 12, 13, 17, 19, 20, 21, 22, 23,
                                                 24, 25, 26, 27, 28, 31, 32, 33]):
                want[raw == label_id] = train_id
            assert set(np.unique(s.label)) <= {255, 0, 1, 2, 4, 13, 18}
        else:
            want = np.asarray(Image.open(gt + "_gtFine_labelTrainIds.png"), np.int32)
        np.testing.assert_array_equal(s.label, want)
    np.testing.assert_array_equal(datasets._CITYSCAPES_ID_TO_TRAIN,
                                  jdatasets._CITYSCAPES_ID_TO_TRAIN)


def _assert_batches_equal(got, want):
    assert sorted(got) == sorted(want)
    for k in want:
        assert got[k].dtype == want[k].dtype, k
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)


@pytest.mark.parametrize("dataset", ["voc", "cityscapes"])
def test_loaders_match_the_reference_for_two_epochs(voc_root, city_root, dataset):
    root = voc_root if dataset == "voc" else city_root
    jcfg, cfg = _cfgs(dataset, root, "1_4")
    kw = dict(seed=3, num_workers=2)
    made = {}
    for side, mod, dmod, c in (("jax", jpipeline, jdatasets, jcfg),
                               ("port", pipeline, datasets, cfg)):
        lab = mod.Loader(dmod.build_dataset(c, "labeled"), 2, **kw)
        unlab = mod.Loader(dmod.build_dataset(c, "unlabeled"), 2, seed=20, num_workers=2)
        val = mod.Loader(dmod.build_dataset(c, "val"), 2, shuffle=False, drop_last=False,
                         pad_mode="blank", num_workers=2)
        made[side] = (mod.DualLoader(lab, unlab), val)
    (jdual, jval), (dual, val) = made["jax"], made["port"]
    assert len(dual) == len(jdual) >= 2
    for epoch in (0, 1):
        pairs = list(dual.epoch(epoch))
        jpairs = list(jdual.epoch(epoch))
        assert len(pairs) == len(jpairs) == len(dual)
        for (l, u), (jl, ju) in zip(pairs, jpairs):
            _assert_batches_equal(l, jl)
            _assert_batches_equal(u, ju)
            assert (u["label"] == 255).all()
        vb, jvb = list(val.epoch(epoch)), list(jval.epoch(epoch))
        assert len(vb) == len(jvb)
        for b, jb in zip(vb, jvb):
            _assert_batches_equal(b, jb)
    for loader in (dual.labeled, dual.unlabeled, val):
        loader.close()


def test_process_blocks_reassemble_the_global_batch(city_root):
    ds = datasets.CityscapesDataset(city_root, CITY_TRAIN)
    kw = dict(seed=3, num_workers=2, canvas_hw=(48, 80))  # small canvases the images fit
    full = pipeline.Loader(ds, 4, **kw)
    parts = [pipeline.Loader(ds, 4, process_index=r, process_count=2, **kw) for r in range(2)]
    jparts = [jpipeline.Loader(ds, 4, process_index=r, process_count=2, **kw) for r in range(2)]
    n = 0
    for epoch in (0, 1):
        for fb, *pbs in zip(full.epoch(epoch), *(p.epoch(epoch) for p in parts + jparts)):
            for key in ("image", "label", "size", "index"):
                np.testing.assert_array_equal(
                    np.concatenate([pb[key] for pb in pbs[:2]], axis=0), fb[key])
            for pb, jpb in zip(pbs[:2], pbs[2:]):
                _assert_batches_equal(pb, jpb)
                assert pb["image"].shape[0] == 2
            n += 1
    assert n == 2 * len(full) == 4
    with pytest.raises(AssertionError):
        pipeline.Loader(ds, 3, process_index=0, process_count=2)


def test_blank_pad_slots_slice_consistently(voc_root):
    ds = datasets.VOCDataset(voc_root, VOC_VAL_IDS, canvas=96)
    full = pipeline.Loader(ds, 4, shuffle=False, drop_last=False, pad_mode="blank",
                           num_workers=1)
    parts = [pipeline.Loader(ds, 4, shuffle=False, drop_last=False, pad_mode="blank",
                             num_workers=1, process_index=r, process_count=2) for r in range(2)]
    batches = list(zip(full.epoch(0), *(p.epoch(0) for p in parts)))
    assert len(batches) == 1
    fb, *pbs = batches[0]
    for key in ("image", "label", "size", "index"):
        np.testing.assert_array_equal(np.concatenate([pb[key] for pb in pbs], axis=0), fb[key])
    # the fourth slot is the blank pad: index -1, size (1, 1), all-ignore labels
    assert list(pbs[1]["index"]) == [2, -1] and tuple(pbs[1]["size"][1]) == (1, 1)
    assert (pbs[1]["label"][1] == 255).all() and (pbs[1]["image"][1] == 0).all()


def test_train_and_eval_entry_points_run_on_the_voc_tree(voc_root, tmp_path, capsys):
    """Config 2 as shipped names VOC: ``python -m ...train`` on the tree
    (``data.data_root`` and the CPU sizes only), then ``python -m ...eval``
    on its checkpoints scores the val ids to the trainer's best mIoU."""
    import json

    import torch

    from semi_supervised_semantic_segmentation_tpu_torch import eval as port_eval
    from semi_supervised_semantic_segmentation_tpu_torch import train

    cfg_path = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
                            "configs", "2_mean_teacher_unet_voc_256.yaml")
    sets = [f"data.data_root={voc_root}", "data.crop_size=64", "data.num_workers=1"]
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        train.main(["--config", cfg_path, "--device", "cpu", "--work_dir", str(tmp_path),
                    "--set", *sets, "train.labeled_batch_size=2", "train.unlabeled_batch_size=2",
                    "train.epochs=1", "train.iters_per_epoch=2"])
        best = json.loads(capsys.readouterr().out.strip().splitlines()[-1])["best_miou"]
        port_eval.main(["--config", cfg_path, "--device", "cpu", "--checkpoint",
                        str(tmp_path / "checkpoints"), "--set", *sets])
    finally:
        torch.set_num_threads(n)
    out = capsys.readouterr().out.strip().splitlines()
    assert out[-1].startswith(f"mIoU: {best:.4f}")
    with open(tmp_path / "metrics.jsonl") as f:
        assert json.loads(f.read().strip().splitlines()[-1])["val"]["miou"] == best
