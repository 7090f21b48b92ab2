"""The port's data pipeline (pea_diffusion_tpu_torch/data) held against the
JAX package's (pea_diffusion_tpu/data) on the same webdataset shards,
written here with PIL as tests/test_data.py writes them (photo-like
gradients rather than one flat colour, so that crops move pixels): brace
expansion and shard splits, bucket assignment, crops and pixel arrays
(bit-equal), caption routing and the quality filters, the bucket batcher's
order under a seed, tar streaming with a corrupt member, the port's own
native reader (built into a temporary directory) against the Python
reader, and whole `make_train_iterator` streams with one C++ reader thread
(PEA_READER_THREADS=1) at 1 and 2 decode workers: batches equal key for
key, pixels bit-equal, the same bucket order. Then the CPU prefetcher's
order, end, early stop and the producer's exception reaching the
consumer."""
import io
import json
import random
import tarfile

import numpy as np
import pytest
import torch
from PIL import Image

from pea_diffusion_tpu.configs.train import DataConfig as JDataConfig
from pea_diffusion_tpu.data import buckets as JB
from pea_diffusion_tpu.data import captions as JC
from pea_diffusion_tpu.data import pipeline as jpipe
from pea_diffusion_tpu.data import wds_reader as jwds
from pea_diffusion_tpu.data.multiplexer import BucketBatcher as JBucketBatcher
from pea_diffusion_tpu_torch.configs import DataConfig
from pea_diffusion_tpu_torch.data import buckets as B
from pea_diffusion_tpu_torch.data import captions as C
from pea_diffusion_tpu_torch.data import native_reader
from pea_diffusion_tpu_torch.data import pipeline as pipe
from pea_diffusion_tpu_torch.data import wds_reader as wds
from pea_diffusion_tpu_torch.data.multiplexer import BucketBatcher

GOOD = [
    {"caption_ori": "一只可爱的猫", "caption_en": "a cute cat",
     "watermark": 0.1, "aesthetic_score": 7.0},
    {"caption_zh": "一条狗", "caption_en": "a dog", "watermark": 0.1, "aesthetic_score": 7.0},
    {"caption_ori_zh": "風景畫", "caption_en": "landscape",
     "watermark": 0.1, "aesthetic_score": 7.0},
    {"caption_zh": "湖边的房子", "caption_en": "a house by a lake", "watermark": 0.2,
     "aesthetic_score": 6.5},
]
SMALL = {"caption_ori": "小图太小", "watermark": 0.1, "aesthetic_score": 9.0}
WATERMARKED = {"caption_zh": "水印", "caption_en": "wm", "watermark": 0.9,
               "aesthetic_score": 9.0}
METAS = GOOD + [SMALL, WATERMARKED]
# one size in each of the nine buckets (the bucket's aspect at 1.25x its
# side, over the 640² area filter), then the two the filters drop
SIZES = [(560, 1120), (560, 1040), (640, 960), (720, 880), (800, 800), (880, 720),
         (960, 640), (1040, 560), (1120, 560)]


def _sample(i):
    k = i % 11
    if k == 9:
        return (100, 100), SMALL
    if k == 10:
        return (800, 800), WATERMARKED
    return SIZES[k], GOOD[i % 4]


T = 12


def _image(size, seed):
    w, h = size
    rng = np.random.default_rng(seed)
    yy, xx = np.mgrid[0:h, 0:w]
    base = (xx * rng.uniform(0.1, 0.4) + yy * rng.uniform(0.1, 0.4)).astype(np.uint8)
    return Image.fromarray(np.stack([base, base[::-1], np.roll(base, seed, 1)], -1))


def _add(tf, name, data):
    info = tarfile.TarInfo(name)
    info.size = len(data)
    tf.addfile(info, io.BytesIO(data))


def _make_shard(path, samples):
    with tarfile.open(path, "w") as tf:
        for i, (key, (size, meta)) in enumerate(samples.items()):
            buf = io.BytesIO()
            _image(size, i).save(buf, "JPEG", quality=90)
            _add(tf, f"{key}.jpg", buf.getvalue())
            _add(tf, f"{key}.json", json.dumps(meta).encode())


@pytest.fixture(scope="module")
def shards(tmp_path_factory):
    d = tmp_path_factory.mktemp("wds")
    for s in range(3):
        _make_shard(d / f"train-0000{s}.tar",
                    {f"s{s}_{i:03d}": _sample(18 * s + i) for i in range(18)})
    return str(d) + "/train-{00000..00002}.tar"


def tokenize(texts, length=T):
    out = np.full((len(texts), length), 4, np.int64)
    for i, t in enumerate(texts):
        ids = [(ord(c) % 995) + 5 for c in t[:length]]
        out[i, :len(ids)] = ids
    return out


def tokenize_zh(texts):
    return tokenize(texts) + 1


@pytest.mark.parametrize("url", ["a-{00..02}.tar", "x-{0..1}.tar::y-{3..4}.tar",
                                 "plain.tar", "d{1..2}/s-{008..011}.tar"])
def test_braceexpand_and_expand_urls_match_jax(url):
    assert wds.braceexpand(url) == jwds.braceexpand(url)
    assert wds.expand_urls(url) == jwds.expand_urls(url)
    shards = wds.expand_urls(url)
    for idx, count in ((0, 1), (1, 2), (0, 3), (2, 3)):
        assert wds.split_by_process(shards, idx, count) == jwds.split_by_process(
            shards, idx, count)
    assert wds.split_shards(shards, 0.5, 0.25, 0.25, seed=3) == jwds.split_shards(
        shards, 0.5, 0.25, 0.25, seed=3)


def test_split_by_process_defaults_to_the_whole_list_without_a_process_group():
    assert not torch.distributed.is_initialized()
    assert wds.split_by_process(["a", "b", "c"]) == ["a", "b", "c"]


@pytest.mark.parametrize("size", [(640, 640), (900, 450), (448, 896), (1000, 500),
                                  (513, 777), (1200, 1201), (700, 560)])
def test_buckets_crops_and_pixels_match_jax(size):
    assert B.assign_bucket(*size) == JB.assign_bucket(*size)
    b = B.assign_bucket(*size)
    dst = tuple(B.BUCKETS[b])
    assert B.scaled_size_to_cover(size, dst) == JB.scaled_size_to_cover(size, dst)
    assert B.center_crop_coords(size, dst) == JB.center_crop_coords(size, dst)
    assert B.random_crop_coords(size, dst, random.Random(7)) == JB.random_crop_coords(
        size, dst, random.Random(7))
    img = _image(size, 3)
    for center in (True, False):
        out, tl = B.resize_and_crop(img, b, center, random.Random(5))
        jout, jtl = JB.resize_and_crop(img, b, center, random.Random(5))
        assert tl == jtl and out.size == tuple(dst)
        np.testing.assert_array_equal(B.normalize_to_tensor(out), JB.normalize_to_tensor(jout))
    assert B.BUCKETS == JB.BUCKETS and B.BUCKET_PROBS == JB.BUCKET_PROBS


@pytest.mark.parametrize("meta", METAS + [
    {"caption_ori": "這是一隻貓 hello!", "caption_en": "a cat"},
    {"caption_ori_en": "english only"}, {"caption_ori_en": "含中文的英文"},
    {"caption_ori": "no chinese", "caption_ori_zh": "中文"}, {"other": 1}])
def test_caption_routing_and_quality_match_jax(meta):
    assert C.route_caption(meta) == JC.route_caption(meta)
    for w, h in ((800, 800), (100, 100), (640, 640)):
        assert C.passes_quality(meta, w, h) == JC.passes_quality(meta, w, h)
    assert C.to_simplified("風景畫國圖") == JC.to_simplified("風景畫國圖")


@pytest.mark.parametrize("seed", [0, 3])
def test_bucket_batcher_order_matches_jax(seed):
    rng = np.random.default_rng(seed)
    samples = [{"bucket_id": int(b), "key": i}
               for i, b in enumerate(rng.choice(9, 600, p=JB.BUCKET_PROBS))]
    kw = dict(buffer_per_bucket=64, max_total_buffer=120, seed=seed)
    got = [[s["key"] for s in b] for b in BucketBatcher(B.BUCKET_PROBS, 4, **kw)(samples)]
    want = [[s["key"] for s in b] for b in JBucketBatcher(JB.BUCKET_PROBS, 4, **kw)(samples)]
    assert got == want and len(got) > 100


def test_tar_streaming_skips_a_corrupt_member_as_jax_does(shards, tmp_path):
    good = wds.expand_urls(shards)[0]
    data = open(good, "rb").read()
    bad = tmp_path / "truncated.tar"
    bad.write_bytes(data[:len(data) // 2 + 100])  # a member cut short
    for path in (good, str(bad)):
        got = list(wds.iter_tar_samples(path))
        want = list(jwds.iter_tar_samples(path))
        assert got == want
    assert len(list(wds.iter_tar_samples(good))) == 18
    assert 0 < len(list(wds.iter_tar_samples(str(bad)))) < 18
    junk = tmp_path / "junk.tar"
    junk.write_bytes(b"not a tar at all")
    assert list(wds.iter_tar_samples(str(junk))) == []


def test_native_reader_matches_the_python_reader(shards, tmp_path):
    paths = wds.expand_urls(shards)
    lib = native_reader.build(tmp_path)
    assert lib.parent == tmp_path and lib.name.startswith("libwds_tar-")
    assert native_reader.build(tmp_path) == lib  # built once, then reused
    py = {s["__key__"]: s for p in paths for s in wds.iter_tar_samples(p)}
    for threads in (1, 3):
        got = list(native_reader.iter_native_samples(paths, threads, build_dir=tmp_path))
        assert sorted(s["__key__"] for s in got) == sorted(py)
        for s in got:
            assert s == py[s["__key__"]]
    one = [s["__key__"] for s in native_reader.iter_native_samples(paths, 1, build_dir=tmp_path)]
    assert one == [s["__key__"] for p in paths for s in wds.iter_tar_samples(p)]


def _jax_iter(shards, workers, zh, **kw):
    cfg = JDataConfig(urls=(shards,), batch_size=3, num_workers=workers, shuffle_buffer=8)
    return jpipe.make_train_iterator(cfg, tokenize, [tokenize, tokenize],
                                     tokenize_zh if zh else None, **kw)


def _port_iter(shards, workers, zh, **kw):
    cfg = DataConfig(urls=(shards,), batch_size=3, num_workers=workers, shuffle_buffer=8)
    return pipe.make_train_iterator(cfg, tokenize, [tokenize, tokenize],
                                    tokenize_zh if zh else None, **kw)


def _assert_batches_equal(got, want):
    assert sorted(got) == sorted(want)
    for k, v in want.items():
        if isinstance(v, list):
            assert got[k] == v, k
            continue
        g = got[k]
        assert torch.is_tensor(g), k
        assert g.dtype == torch.from_numpy(np.asarray(v)).dtype, k
        np.testing.assert_array_equal(g.numpy(), np.asarray(v), err_msg=k)


@pytest.mark.parametrize("workers", [1, 2])
def test_make_train_iterator_matches_jax(shards, workers, monkeypatch):
    monkeypatch.setenv("PEA_READER_THREADS", "1")
    wds.sample_stream.samples = {"native": 0, "python": 0}
    n = 8
    got = [b for _, b in zip(range(n), _port_iter(shards, workers, False, seed=2,
                                                  start_step=5))]
    want = [b for _, b in zip(range(n), _jax_iter(shards, workers, False, seed=2,
                                                  start_step=5))]
    assert [int(b["bucket_id"]) for b in got] == [int(b["bucket_id"]) for b in want]
    assert len({int(b["bucket_id"]) for b in got}) >= 4
    for g, w in zip(got, want):
        _assert_batches_equal(g, w)
        assert g["pixel_values"].dtype == torch.float32
        assert g["time_ids"].shape == (3, 6) and g["zh_or_not"].dtype == torch.float32
        h, w_ = g["pixel_values"].shape[1:3]
        assert [w_, h] == B.BUCKETS[int(g["bucket_id"])]
    assert wds.sample_stream.samples["native"] > 0 and wds.sample_stream.samples["python"] == 0


def test_mul_zh_batches_carry_the_chinese_ids_as_jax_does(shards, monkeypatch):
    monkeypatch.setenv("PEA_READER_THREADS", "1")
    got = next(_port_iter(shards, 1, True))
    want = next(_jax_iter(shards, 1, True))
    _assert_batches_equal(got, want)
    assert {"input_ids_zh", "input_ids_uncond_zh"} <= set(got)
    np.testing.assert_array_equal(got["input_ids_zh"].numpy(), got["input_ids"].numpy() + 1)


def test_one_epoch_ends_the_stream_with_every_full_batch(shards, monkeypatch):
    monkeypatch.setenv("PEA_READER_THREADS", "1")
    batches = list(_port_iter(shards, 2, False, epochs=1))
    # 54 samples, 10 dropped by the filters (the 100² and watermark 0.9 ones)
    keys = [p for b in batches for p in b["prompts"]]
    assert 0 < len(keys) <= 44 and len(keys) == 3 * len(batches)
    assert "水印" not in keys and "小图太小" not in keys
    assert all(len(set(b["bucket_id"].reshape(-1).tolist())) == 1 for b in batches)


def test_prefetcher_keeps_order_and_ends_on_the_cpu():
    src = [{"x": torch.full((2,), float(i)), "prompts": [f"p{i}"]} for i in range(5)]
    pre = pipe.prefetch_to_device(iter(src), "cpu", depth=2)
    out = list(pre)
    assert [b["prompts"] for b in out] == [s["prompts"] for s in src]
    for o, s in zip(out, src):
        assert torch.equal(o["x"], s["x"]) and o["x"].data_ptr() != s["x"].data_ptr()
    pre.thread.join(timeout=10)
    assert not pre.thread.is_alive()


def test_prefetcher_raises_the_producers_exception_in_the_consumer():
    def source():
        yield {"x": torch.zeros(1)}
        raise KeyError("bad shard")

    pre = pipe.prefetch_to_device(source(), "cpu")
    it = iter(pre)
    assert torch.equal(next(it)["x"], torch.zeros(1))
    with pytest.raises(KeyError, match="bad shard"):
        next(it)
    pre.thread.join(timeout=10)
    assert not pre.thread.is_alive()


def test_prefetcher_stops_its_thread_and_closes_the_source_when_the_consumer_stops():
    closed = []

    def source():
        try:
            for i in range(1000):
                yield {"x": torch.tensor([i])}
        finally:
            closed.append(True)

    pre = pipe.prefetch_to_device(source(), "cpu", depth=2)
    for i, b in enumerate(pre):
        if i == 2:
            break
    pre.thread.join(timeout=10)
    assert not pre.thread.is_alive() and closed == [True]


def test_prefetcher_refuses_a_card_that_is_not_there(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        pipe.prefetch_to_device(iter([]), "cuda")
