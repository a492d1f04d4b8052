"""The port's data pipeline against the JAX package's: the copied modules
(datasets, safetensors reader/writer, metrics logger), media loading, and
``BatchLoader`` / ``StreamingBatchLoader`` batches, which must be the same
arrays for the same seed, epoch and skip; then the torch prefetch, which
must hand out tensors equal to the host batches (on the card: after its
side-stream copy)."""

import json
import time

import numpy as np
import pytest
import torch

from macaw_llm_tpu import config as jconfig
from macaw_llm_tpu.data import datasets as jds
from macaw_llm_tpu.data import loader as jloader
from macaw_llm_tpu.utils import logging as jlogging
from macaw_llm_tpu.utils import safetensors_io as jst
from macaw_llm_tpu_torch import config as tconfig
from macaw_llm_tpu_torch.data import datasets as tds
from macaw_llm_tpu_torch.data import loader as tloader
from macaw_llm_tpu_torch.utils import logging as tlogging
from macaw_llm_tpu_torch.utils import safetensors_io as tst
from tests.test_data import FakeTokenizer, _write_wav


def _equal_batches(a: dict, b: dict):
    assert sorted(a) == sorted(b)
    for k in a:
        assert a[k].dtype == b[k].dtype and a[k].shape == b[k].shape, k
        np.testing.assert_array_equal(a[k], b[k], err_msg=k)


@pytest.fixture(scope="module")
def media_dir(tmp_path_factory):
    """One AVSD video (frames + audio) and one COCO image, with the name
    table and the tokenized rows both packages build from them."""
    from PIL import Image
    root = tmp_path_factory.mktemp("media")
    (root / "frames").mkdir()
    (root / "audios").mkdir()
    rng = np.random.RandomState(0)
    for i in range(12):
        Image.fromarray(rng.randint(0, 255, (48, 40, 3), np.uint8)).save(
            str(root / "frames" / f"vid1_{i}.jpg"))
    Image.fromarray(rng.randint(0, 255, (30, 50, 3), np.uint8)).save(
        str(root / "COCO_train2014_000000000009.jpg"))
    _write_wav(str(root / "audios" / "vid1.wav"), n=20000)
    return root


def _data_cfgs(root):
    kw = dict(image_dir=str(root / "frames") + "/",
              audio_dir=str(root / "audios") + "/",
              coco_dir=str(root) + "/", n_stored_frames=12,
              n_sampled_frames=6)
    return jconfig.DataConfig(**kw), tconfig.DataConfig(**kw)


def _datasets(mod):
    tok = FakeTokenizer()
    table = mod.build_name_table(["COCO_train2014_000000000009.jpg"],
                                 ["vid1"])
    vqa = mod.build_vqa(tok, [{"instruction": f"what {k}", "output": "yes",
                               "image": "COCO_train2014_9.jpg"}
                              for k in range(5)],
                        table["dict"], max_len=32)
    avsd = mod.build_avsd(tok, [{"video": "vid1",
                                 "turns": [{"question": f"q{k}",
                                            "answer": "a b"}
                                           for k in range(7)]}],
                          table["dict"], max_len=32)
    alpaca = mod.build_alpaca(tok, [{"instruction": f"say {k}", "input": "",
                                     "output": "ok"} for k in range(6)],
                              max_len=32)
    mixed = mod.mix_datasets(np.random.RandomState(3), [vqa, avsd, alpaca],
                             per_part=100)
    return table, mixed


def test_copied_dataset_builders_match_jax():
    jt, jd = _datasets(jds)
    tt, td = _datasets(tds)
    assert jt == tt
    for f in ("input_ids", "attention_mask", "labels", "images", "audios",
              "videos"):
        np.testing.assert_array_equal(getattr(jd, f), getattr(td, f))


def test_load_image_and_media_source_match_jax(media_dir):
    jd, td = _data_cfgs(media_dir)
    table, _ = _datasets(tds)
    jm = jloader.MediaSource(table["list"], jd, image_size=32, n_frames=6)
    tm = tloader.MediaSource(table["list"], td, image_size=32, n_frames=6)
    for idx in (-1, 0, 1):
        np.testing.assert_array_equal(jm.image(idx), tm.image(idx))
        np.testing.assert_array_equal(jm.audio(idx), tm.audio(idx))
        np.testing.assert_array_equal(jm.video(idx), tm.video(idx))
    assert tm.image(0).max() > 0 and tm.video(1).max() > 0
    assert tm.audio(1).max() > 0
    png = str(media_dir / "x.png")
    from PIL import Image
    Image.fromarray(np.arange(40 * 30 * 3, dtype=np.uint8).reshape(
        40, 30, 3)).save(png)
    np.testing.assert_array_equal(jloader.load_image(png, 24),
                                  tloader.load_image(png, 24))


@pytest.mark.parametrize("epoch,skip,accum", [(0, 0, 2), (1, 1, 1),
                                              (2, 2, 2)])
def test_batch_loader_matches_jax(media_dir, epoch, skip, accum):
    jd, td = _data_cfgs(media_dir)
    table, ds = _datasets(tds)
    jl = jloader.BatchLoader(
        ds, jloader.MediaSource(table["list"], jd, image_size=32),
        global_batch=4, accum=accum, seed=5, num_workers=2)
    tl = tloader.BatchLoader(
        ds, tloader.MediaSource(table["list"], td, image_size=32),
        global_batch=4, accum=accum, seed=5, num_workers=2)
    assert jl.steps_per_epoch == tl.steps_per_epoch == len(ds) // 4
    jb = list(jl.epoch(epoch, skip=skip))
    tb = list(tl.epoch(epoch, skip=skip))
    assert len(tb) == tl.steps_per_epoch - skip
    for a, b in zip(jb, tb):
        _equal_batches(a, b)
    assert tb[0]["input_ids"].shape == (accum, 4 // accum, 32)


def _rows(path, n=40):
    rows = []
    for i in range(n):
        row = {"instruction": f"question {i}", "output": f"answer {i}"}
        if i % 3 == 0:
            row["video"] = "vid1"
        if i % 7 == 0:  # the prompt alone reaches max_len: dropped
            row["instruction"] = " ".join(["w"] * 60)
        rows.append(row)
    path.write_text("\n".join(json.dumps(r) for r in rows) + "\n")
    return str(path)


@pytest.mark.parametrize("epoch,skip", [(0, 0), (1, 2)])
def test_streaming_loader_matches_jax(media_dir, tmp_path, epoch, skip):
    jd, td = _data_cfgs(media_dir)
    table, _ = _datasets(tds)
    path = _rows(tmp_path / "rows.jsonl")
    kw = dict(name_table=table["dict"], global_batch=4, accum=2,
              max_text_len=32, shuffle_buffer=8, seed=2, steps_per_epoch=4,
              num_workers=2)
    jl = jloader.StreamingBatchLoader(
        [path], FakeTokenizer(),
        media=jloader.MediaSource(table["list"], jd, image_size=32), **kw)
    tl = tloader.StreamingBatchLoader(
        [path], FakeTokenizer(),
        media=tloader.MediaSource(table["list"], td, image_size=32), **kw)
    jb = list(jl.epoch(epoch, skip=skip))
    tb = list(tl.epoch(epoch, skip=skip))
    assert len(tb) == len(jb) == 4 - skip
    for a, b in zip(jb, tb):
        _equal_batches(a, b)
    assert any(b["videos"].max() > 0 for b in tb)


@pytest.mark.parametrize("n_files", [1, 2, 3])
def test_stream_jsonl_matches_jax(tmp_path, n_files):
    """The rows of several shard files (blank lines skipped) in JAX's order
    at its single-process setting."""
    paths = [_rows(tmp_path / f"rows{i}.jsonl", n=11 + i)
             for i in range(n_files)]
    with open(paths[0], "a") as f:
        f.write("\n\n")
    rows = list(tloader.stream_jsonl(paths))
    assert len(rows) == sum(11 + i for i in range(n_files))
    assert rows == list(jloader.stream_jsonl(paths, 0, 1))


def test_prefetch_returns_equal_tensors_cpu():
    """On the CPU the prefetch converts in order; the card's side-stream
    copies are held by tests/test_torch_cuda.py."""
    rng = np.random.RandomState(0)
    host = [{"input_ids": rng.randint(0, 32000, (2, 3, 16)).astype(np.int32),
             "audios": rng.randn(2, 3, 100).astype(np.float32)}
            for _ in range(3)]
    got = list(tloader.device_prefetch(iter(host), device="cpu"))
    assert len(got) == 3
    for g, r in zip(got, host):
        assert g["input_ids"].dtype == torch.int64  # torch's index dtype
        assert g["audios"].dtype == torch.float32
        for k in r:
            np.testing.assert_array_equal(g[k].numpy(), r[k])


def test_safetensors_io_matches_jax(tmp_path):
    rng = np.random.RandomState(0)
    tensors = {"a": rng.randn(3, 4).astype(np.float32),
               "b": rng.randint(-5, 5, (7,)).astype(np.int8),
               "c": rng.randn(2, 2).astype(np.float16)}
    tst.save_safetensors(tensors, str(tmp_path / "t.safetensors"))
    jst.save_safetensors(tensors, str(tmp_path / "j.safetensors"))
    assert (tmp_path / "t.safetensors").read_bytes() == \
        (tmp_path / "j.safetensors").read_bytes()
    got = tst.load_checkpoint_dir(str(tmp_path))
    ref = jst.load_checkpoint_dir(str(tmp_path))
    for k in tensors:
        np.testing.assert_array_equal(got[k], ref[k])
        np.testing.assert_array_equal(got[k], tensors[k])


def test_metrics_logger_writes_jax_rows(tmp_path, monkeypatch):
    """Same rows for the same calls (the clock pinned in both), with
    torch scalars where the JAX package logs device arrays."""
    rows = {}
    for name, mod, scalar in (("jax", jlogging, np.float32),
                              ("torch", tlogging, torch.tensor)):
        clock = iter(np.arange(0.0, 100.0, 0.5))
        monkeypatch.setattr(time, "perf_counter",
                            lambda: float(next(clock)))
        path = tmp_path / f"{name}.jsonl"
        log = mod.MetricsLogger(str(path), log_every=2)
        for step in (1, 2, 3):
            log.log(step, {"loss": scalar(1.5 / step)}, tokens_per_batch=64,
                    examples_per_batch=4, n_chips=1)
        log.log(3, {"eval_loss": scalar(0.25)})
        log.close()
        rows[name] = [json.loads(line) for line in path.read_text().split(
            "\n") if line]
    assert rows["torch"] == rows["jax"] and len(rows["torch"]) == 4
