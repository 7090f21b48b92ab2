"""End-to-end input pipeline (the port of ``pea_diffusion_tpu/data/
pipeline.py``): shards -> decode -> filter -> bucket -> preprocess ->
same-bucket batches -> device prefetch.

Host-side threads and PIL decode feed the card through a prefetcher that
copies each batch from pinned host memory on a side stream. Batch layout
matches the KD train step (train/kd.py): NHWC pixel tensors in [-1, 1],
student + teacher token ids, SDXL time_ids, zh_or_not tags, as torch CPU
tensors with the JAX package's dtypes.

Unlike the JAX package's ``DevicePrefetcher``, whose worker thread ends on
an exception and posts the end marker (so the training loop sees the data
end normally), this prefetcher raises the producer's exception in the
consumer.
"""
from __future__ import annotations

import dataclasses
import queue
import random
import threading
import zlib
from typing import Callable, Dict, Iterable, Iterator, List, Optional, Sequence, Union

import numpy as np
import torch

from ..configs.train import DataConfig
from . import buckets as B
from . import captions as C
from .multiplexer import BucketBatcher
from .wds_reader import (decode_sample, expand_urls, sample_stream,
                         split_by_process, split_shards)

TokenizeFn = Callable[[List[str]], np.ndarray]  # texts -> [B, T] int ids


def parallel_map(fn, it, workers: int, prefetch: Optional[int] = None):
    """Ordered, bounded thread-pool map (the MultiProcessingReadingService
    analog, utils/custom_dataset_sdxl.py:212-215 — threads instead of
    processes because PIL jpeg decode/resize release the GIL, so decode
    scales on host cores without pickling batches). `None` results pass
    through for the caller to filter. Bounded in-flight window keeps host
    RAM flat when the consumer stalls on a device step."""
    if workers <= 1:
        yield from map(fn, it)
        return
    from collections import deque
    from concurrent.futures import ThreadPoolExecutor

    depth = prefetch or workers * 4
    with ThreadPoolExecutor(workers) as ex:
        futs: deque = deque()
        for item in it:
            futs.append(ex.submit(fn, item))
            if len(futs) >= depth:
                yield futs.popleft().result()
        while futs:
            yield futs.popleft().result()


@dataclasses.dataclass
class Preprocessor:
    """verify_keys + preproc (utils/custom_dataset_sdxl.py:53-88,282-381)."""

    cfg: DataConfig
    tokenize: TokenizeFn
    center_crop: bool = False
    seed: int = 0

    def _sample_rng(self, sample: dict) -> random.Random:
        """Per-sample RNG keyed on (pipeline seed, sample key).

        A single shared `random.Random` would be consumed concurrently from
        `parallel_map`'s decode threads — crops would become nondeterministic
        (and correlated) under num_workers>1. Deriving the stream from the
        sample's own key makes every crop deterministic and independent of
        worker count / arrival order. crc32, not hash(): str hashing is
        salted per-process."""
        key = f"{self.seed}:{sample.get('__key__', '')}"
        return random.Random(zlib.crc32(key.encode("utf-8")))

    def __call__(self, sample: dict) -> Optional[dict]:
        if "json" not in sample or "jpg" not in sample:
            return None
        rng = self._sample_rng(sample)
        img, meta = sample["jpg"], sample["json"]
        w, h = img.size
        if not C.passes_quality(meta, w, h, min_area=self.cfg.min_area,
                                min_aesthetic=self.cfg.min_aesthetic,
                                max_watermark=self.cfg.max_watermark):
            return None
        if self.cfg.bucketing:
            bucket_id = B.assign_bucket(w, h)
            img, (top, left) = B.resize_and_crop(
                img, bucket_id, self.center_crop, rng)
        else:
            # SD1.5 path: fixed square resolution (custom_dataset.py:79-186)
            bucket_id = 0
            res = self.cfg.resolution
            nw, nh = B.scaled_size_to_cover(img.size, (res, res))
            img = img.resize((nw, nh), resample=2)
            if self.center_crop:
                top, left = B.center_crop_coords((nw, nh), (res, res))
            else:
                top, left = B.random_crop_coords((nw, nh), (res, res), rng)
            img = img.crop((left, top, left + res, top + res))
        prompt, zh_or_not, caption_en = C.route_caption(meta)
        return {
            "pixel_values": B.normalize_to_tensor(img),
            "original_size": (w, h),
            "crops_coords_top_left": (top, left),
            "bucket_id": bucket_id,
            "prompt": prompt,
            "caption_en": caption_en,
            "zh_or_not": zh_or_not,
        }


def collate(
    examples: List[dict],
    tokenize: TokenizeFn,
    teacher_tokenize: Optional[Sequence[TokenizeFn]] = None,
    tokenize_zh: Optional[TokenizeFn] = None,
) -> Dict[str, Union[torch.Tensor, List[str]]]:
    """Same-bucket batch -> torch CPU tensors (collate_fn,
    utils/custom_dataset_sdxl.py:384-409): float32 pixels, sizes, crops and
    time ids, the tokenizers' integer ids, int32 bucket_id, float32
    zh_or_not; `prompts` and `texts_en` stay lists. Student ids are
    tokenized here (host), teacher ids too when teacher tokenizers are
    provided.

    SDXL time_ids use the framework-wide (h, w, top, left, h, w) convention;
    the reference mixes PIL (w,h) with crop (y,x) — see SURVEY.md §2a."""
    n = len(examples)
    prompts = [e["prompt"] for e in examples]
    bucket_id = examples[0]["bucket_id"]
    pixel_values = np.stack([e["pixel_values"] for e in examples])
    th, tw = pixel_values.shape[1], pixel_values.shape[2]  # target size
    batch: Dict[str, np.ndarray] = {
        "pixel_values": pixel_values,
        "original_size": np.array(
            [(e["original_size"][1], e["original_size"][0]) for e in examples],
            np.float32),
        "crops_coords_top_left": np.array(
            [e["crops_coords_top_left"] for e in examples], np.float32),
        "bucket_id": np.int32(bucket_id),
        "zh_or_not": np.array([e["zh_or_not"] for e in examples], np.float32),
        "input_ids": tokenize(prompts),
        "input_ids_uncond": tokenize([""] * n),
        "prompts": prompts,
        "texts_en": [e["caption_en"] for e in examples],
    }
    batch["time_ids"] = np.concatenate(
        [batch["original_size"], batch["crops_coords_top_left"],
         np.tile(np.array([[th, tw]], np.float32), (n, 1))], axis=1)
    if tokenize_zh is not None:  # mul_zh dual student tokenization
        batch["input_ids_zh"] = tokenize_zh(prompts)
        batch["input_ids_uncond_zh"] = tokenize_zh([""] * n)
    if teacher_tokenize is not None:
        for i, tok in enumerate(teacher_tokenize, start=1):
            batch[f"teacher_ids_{i}"] = tok(batch["texts_en"])
            batch[f"teacher_uncond_ids_{i}"] = tok([""] * n)
    return {k: torch.from_numpy(np.asarray(v)) if isinstance(v, (np.ndarray, np.generic))
            else v for k, v in batch.items()}


def make_train_iterator(
    cfg: DataConfig,
    tokenize: TokenizeFn,
    teacher_tokenize: Optional[Sequence[TokenizeFn]] = None,
    tokenize_zh: Optional[TokenizeFn] = None,
    *,
    process_index: Optional[int] = None,
    process_count: Optional[int] = None,
    seed: int = 0,
    start_step: int = 0,
    epochs: Optional[int] = None,
) -> Iterator[Dict[str, Union[torch.Tensor, List[str]]]]:
    """Shard-partitioned, bucketed, batched stream of train batches.
    Decode + preprocess run on a `cfg.num_workers`-thread pool over RAW
    (compressed) samples; the shuffle buffer holds bytes, not pixels.

    `start_step` is the resume position (the reference restores
    `consumed_samples` in on_load_checkpoint, train_sdxl_zh.py:454-458, to
    re-seed its loader): it folds the resumed step into the stream seed so
    shard order, shuffle buffer, crop RNG base and bucket draws all differ
    from the consumed prefix — the shard-reshuffle equivalence argument for
    epochless webdataset streams (docs/DESIGN.md §10). Crop coords stay a
    pure function of (seed, sample key) and so remain reproducible.

    `epochs` None streams the shards without end, as the JAX package does;
    a count ends the stream after that many passes, the batcher's full
    batches drained."""
    all_shards = expand_urls(list(cfg.urls))
    if cfg.train_split < 1.0:
        all_shards, _, _ = split_shards(
            all_shards, cfg.train_split, cfg.val_split, cfg.test_split, seed)
    shards = split_by_process(all_shards, process_index, process_count)
    if not shards:
        raise ValueError("no shards for this process")
    # NB: the split seed above stays `seed` (resume must not move samples
    # across the train/val/test boundary); only stream order re-seeds.
    stream_seed = seed + start_step
    pre = Preprocessor(cfg, tokenize, cfg.center_crop, stream_seed)

    def decode_and_pre(raw):
        s = decode_sample(raw)
        if s is None or "jpg" not in s:
            return None
        return pre(s)

    stream = sample_stream(shards, shuffle_buffer=cfg.shuffle_buffer,
                           seed=stream_seed, resample=cfg.resample_shards,
                           decode=False, epochs=epochs)
    processed = (p for p in parallel_map(decode_and_pre, stream,
                                         cfg.num_workers) if p is not None)
    batcher = BucketBatcher(B.BUCKET_PROBS, cfg.batch_size, seed=stream_seed)
    for batch in batcher(processed):
        yield collate(batch, tokenize, teacher_tokenize, tokenize_zh)


class _Failure:
    def __init__(self, exc: BaseException):
        self.exc = exc


_END = object()


class DevicePrefetcher:
    """A thread that moves host batches to `device`, `depth` ahead (the
    DataLoaderX/BackgroundGenerator analog, utils/custom_dataset.py:216).

    On a card each tensor is copied to pinned host memory and on to the card
    with ``non_blocking`` on a side stream, which records an event; the
    consumer's stream waits on that event before the batch is handed over,
    and each device tensor is marked used on the consumer's stream
    (``record_stream``), so that the caching allocator does not give its
    memory back to the side stream while the step still reads it. The
    pinned buffers stay reserved by PyTorch's host allocator until their
    copies complete. On a CPU device the tensors are plain copies. Other
    entries (prompt lists) pass through. An exception in the producer is
    raised in the consumer; ``close`` (also run when the consumer stops
    iterating) stops the thread and closes the source iterator."""

    def __init__(self, it: Iterable, device, depth: int = 2):
        self.device = torch.device(device)
        if self.device.type == "cuda" and self.device.index is None:
            # the rank's own card (parallel.initialize makes it current): the
            # producer thread's current card is card 0
            self.device = torch.device("cuda", torch.cuda.current_device())
        self.q: "queue.Queue" = queue.Queue(maxsize=depth)
        self._stop = threading.Event()
        self._stream = (torch.cuda.Stream(self.device) if self.device.type == "cuda"
                        else None)
        self.thread = threading.Thread(target=self._work, args=(iter(it),), daemon=True)
        self.thread.start()

    def _copy(self, batch: Dict):
        if self._stream is None:
            return {k: v.to(self.device, copy=True) if torch.is_tensor(v) else v
                    for k, v in batch.items()}, None
        with torch.cuda.stream(self._stream):
            out = {k: (v.pin_memory() if v.device.type == "cpu" else v).to(
                       self.device, non_blocking=True) if torch.is_tensor(v) else v
                   for k, v in batch.items()}
            event = torch.cuda.Event()
            event.record(self._stream)
        return out, event

    def _put(self, item) -> bool:
        while not self._stop.is_set():
            try:
                self.q.put(item, timeout=0.1)
                return True
            except queue.Full:
                pass
        return False

    def _work(self, it):
        try:
            for batch in it:
                if not self._put(self._copy(batch)):
                    break
        except BaseException as e:  # noqa: BLE001 -- handed to the consumer, raised there
            self._put(_Failure(e))
        finally:
            close = getattr(it, "close", None)
            if close is not None:
                close()
            self._put(_END)

    def __iter__(self):
        try:
            while True:
                item = self.q.get()
                if item is _END:
                    return
                if isinstance(item, _Failure):
                    raise item.exc
                batch, event = item
                if event is not None:
                    stream = torch.cuda.current_stream(self.device)
                    stream.wait_event(event)
                    for v in batch.values():
                        if torch.is_tensor(v) and v.is_cuda:
                            v.record_stream(stream)
                yield batch
        finally:
            self.close()

    def close(self):
        """Stops the producer, drops the batches it queued and waits for it."""
        self._stop.set()
        while self.thread.is_alive():
            try:
                self.q.get(timeout=0.1)
            except queue.Empty:
                pass
        self.thread.join()


def prefetch_to_device(it, device="cuda", depth: int = 2) -> DevicePrefetcher:
    """Wrap a host batch iterator with asynchronous copies to `device` (the
    card unless the caller asks for the CPU; raises if a card is asked for
    and there is none). A bare "cuda" is this rank's local card, the
    current one."""
    from ..pipelines.factory import resolve_device

    return DevicePrefetcher(it, resolve_device(device), depth)
