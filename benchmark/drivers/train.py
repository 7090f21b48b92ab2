"""KD training of the PEA adapter through the program's trainer
(``train/trainer.py::KDTrainer.fit`` over ``train/kd.py``'s step), fed one
of two ways:

- a mix without ``"shards"``: batches made from the seed before the window
  and kept in host memory, ``batch`` rows of ``size``² images in [-1, 1],
  seeded student ids, empty negative prompts, seeded teacher ids,
  Chinese-native and parallel-English rows at random. The checked steps
  each get their own batch; the window cycles through ``pool`` more.
  ``fit`` copies each step's batch to the card; no data pipeline runs.
- a mix with ``"shards"``: webdataset shards written from the seed into a
  temporary directory at set-up (``datasets.py``), read through the
  program's data pipeline (``data/pipeline.py::make_train_iterator``:
  the tar reader, ``decode_workers`` decode threads, aspect buckets, the
  bucket batcher, collate with the benchmark's tokenizers) and its device
  prefetcher, with the pipeline's seed ``data_seed`` and its default
  tar reader threads, its rate reported as ``rate_metric``. Set-up runs
  the trainer's warm-up over every bucket. The check also holds each checked batch
  against the reference's data stage (``reference/data.py``):
  ``batch_gap``.

Set-up builds the one trainer and drives it through ``checked_steps``
steps with the window's own call and feed (they warm every shape); the
benchmark keeps each step's loss, AdamW's first moment after step 1 and
the adapter after the last of them, for the check. The window opens at
that step's completion and closes at the first step completed at least the
run's seconds later. The feed never synchronises inside the window, so the
host runs ahead as in training: it records a CUDA event each time ``fit``
asks for a batch (the completion of every step queued before it, read on the
host's clock after the window), and once the host's clock has passed the
run's seconds it waits for the device and stops. With --trace 1,
``trace_steps`` more steps run under the profiler after the window.
"""
from __future__ import annotations

import tempfile
import time
from pathlib import Path
from typing import Dict, Iterator, List, Optional

import torch

from .. import datasets, harness, port_stack
from ..reference import checks
from ..reference import data as data_ref

# what the step takes of a batch, and the check compares
STEP_KEYS = ("pixel_values", "input_ids", "input_ids_uncond", "teacher_ids_1",
             "teacher_ids_2", "teacher_uncond_ids_1", "teacher_uncond_ids_2", "time_ids",
             "zh_or_not")


def make_batch(config: Dict, tr: Dict, seed: int, step: int, device) -> Dict:
    comp = config["components"]
    g = torch.Generator(device=device).manual_seed((int(seed) * 1_000_003 + 17 * step + 5)
                                                   % (2 ** 63))
    b, s, t, tt = tr["batch"], tr["size"], tr["text_tokens"], tr["teacher_tokens"]

    def ints(hi, shape):
        return torch.randint(4, hi, shape, generator=g, device=device)

    batch = {
        "pixel_values": torch.rand((b, s, s, 3), generator=g, device=device) * 2 - 1,
        "input_ids": ints(comp["text_encoder"]["config"]["vocab_size"], (b, t)),
        "input_ids_uncond": torch.full((b, t), 4, device=device),
    }
    for k in (1, 2):
        name = f"teacher_{k}"
        if name in comp:
            batch[f"teacher_ids_{k}"] = ints(comp[name]["config"]["vocab_size"] - 1, (b, tt))
            batch[f"teacher_uncond_ids_{k}"] = torch.full((b, tt), 4, device=device)
    if "teacher_2" in comp:
        batch["time_ids"] = torch.tensor([[s, s, 0, 0, s, s]], dtype=torch.float32,
                                         device=device).repeat(b, 1)
    batch["zh_or_not"] = torch.randint(0, 2, (b,), generator=g, device=device).float()
    return batch


def host_batches(config: Dict, tr: Dict, seed: int, device) -> List[Dict]:
    """The run's batches, made on `device` from the seed and copied to host
    memory: steps 0 .. checked_steps - 1, then the window's pool."""
    n = tr["checked_steps"] + tr["pool"]
    return [{k: v.cpu() for k, v in make_batch(config, tr, seed, s, device).items()}
            for s in range(n)]


class HostBatches:
    """The mix's batches in host memory (`host_batches`)."""

    def __init__(self, config: Dict, tr: Dict, seed: int, device):
        self.tr, self.device = tr, device
        self.batches = host_batches(config, tr, seed, device)

    def next(self, step: int) -> Dict:
        checked = self.tr["checked_steps"]
        return self.batches[step if step < checked
                            else checked + (step - checked) % self.tr["pool"]]

    def checked(self) -> List[Dict]:
        """The checked steps' batches on the device, for the reference."""
        return [{k: v.to(self.device) for k, v in b.items()}
                for b in self.batches[:self.tr["checked_steps"]]]

    def gap(self) -> Optional[float]:
        return None

    def close(self):
        self.batches = []


class ShardBatches:
    """The mix's shards through the program's data pipeline."""

    def __init__(self, config: Dict, tr: Dict, seed: int, device):
        from pea_diffusion_tpu_torch.configs.train import DataConfig
        from pea_diffusion_tpu_torch.data.pipeline import (make_train_iterator,
                                                           prefetch_to_device)

        self.tr, self.device, spec = tr, device, tr["shards"]
        self.dir = tempfile.TemporaryDirectory()
        root = Path(self.dir.name)
        self.samples = datasets.write_shards(spec, seed, root)
        comp = config["components"]
        self.tokenize = datasets.student_tokenizer(
            comp["text_encoder"]["config"]["vocab_size"], tr["text_tokens"])
        self.teacher_tokenize = [
            datasets.teacher_tokenizer(comp[f"teacher_{k}"]["config"]["eos_token_id"],
                                       tr["teacher_tokens"], pad)
            for k, pad in enumerate(tr["teacher_pad"], start=1)]
        data_cfg = DataConfig(urls=(datasets.shard_urls(spec, root),),
                              num_workers=tr["decode_workers"], batch_size=tr["batch"],
                              bucketing=True)
        self.prefetcher = prefetch_to_device(
            make_train_iterator(data_cfg, self.tokenize, self.teacher_tokenize,
                                seed=tr["data_seed"]), device)
        self.it = iter(self.prefetcher)
        self.kept: List[Dict] = []
        self._expected: Optional[List[Dict]] = None

    def next(self, step: int) -> Dict:
        batch = next(self.it)
        if step < self.tr["checked_steps"]:
            self.kept.append({k: (v.cpu().numpy() if torch.is_tensor(v) else v)
                              for k, v in batch.items() if k in STEP_KEYS + ("prompts",)})
        return batch

    def expected(self) -> List[Dict]:
        if self._expected is None:
            self._expected = [
                data_ref.expected_batch(b["prompts"], self.samples, self.tr["data_seed"],
                                        self.tr["shards"]["buckets"], self.tokenize,
                                        self.teacher_tokenize) for b in self.kept]
        return self._expected

    def checked(self) -> List[Dict]:
        """The checked steps' batches as the reference's data stage makes
        them, on the device."""
        return [{k: torch.as_tensor(v, device=self.device) for k, v in b.items()
                 if k != "prompts"} for b in self.expected()]

    def gap(self) -> Optional[float]:
        return max(data_ref.batch_gap(p, e) for p, e in zip(self.kept, self.expected()))

    def close(self):
        self.prefetcher.close()
        self.dir.cleanup()


def batch_source(config: Dict, tr: Dict, seed: int, device):
    return (ShardBatches if "shards" in tr else HostBatches)(config, tr, seed, device)


def hyper(config: Dict, tr: Dict) -> Dict:
    hp = dict(tr["train"])
    hp["vae_scaling"] = config["components"]["vae"]["config"]["scaling_factor"]
    return hp


def run(config: Dict, tr: Dict, lims: Dict, seed: int, seconds: float, trace: bool,
        t_start: float, device: str = "cuda", variant: str = "program") -> Dict:
    from pea_diffusion_tpu_torch.configs.train import TrainConfig
    from pea_diffusion_tpu_torch.train.trainer import KDTrainer

    if variant != "program":  # training's control runs in the reference (tools/readings.py)
        raise ValueError(f"train runs the program only, not {variant!r}")
    cuda = torch.device(device).type == "cuda"

    def sync():
        if cuda:
            torch.cuda.synchronize()

    hp = hyper(config, tr)
    models = port_stack.kd_models(config, seed, device)
    models.remat_policy = hp["remat_policy"]
    out_dir = tempfile.TemporaryDirectory()
    cfg = TrainConfig(
        learning_rate=hp["learning_rate"], min_learning_rate=hp["min_learning_rate"],
        total_steps=hp["total_steps"], weight_decay=hp["weight_decay"],
        adam_beta1=hp["adam_beta1"], adam_beta2=hp["adam_beta2"],
        adam_epsilon=hp["adam_epsilon"], warmup_steps=0, warmup_ratio=0.0,
        noise_offset=hp["noise_offset"], cfg_dropout=hp["cfg_dropout"],
        feature_loss_weight=hp["feature_loss_weight"], kd=hp["kd"],
        hybrid_training=hp["hybrid_training"], batch_size_per_device=tr["batch"],
        seed=int(seed), output_dir=out_dir.name, log_every_n_steps=hp["log_every_n_steps"],
        every_n_steps=hp["every_n_steps"])
    trainer = KDTrainer(models, cfg)
    params = dict(models.adapter.named_parameters())
    kept = {"p0": {k: p.detach().float().clone() for k, p in params.items()},
            "losses": [], "hw": []}
    checked = tr["checked_steps"]
    step_fn = trainer.step_fn

    def recorded_step(state, batch, gen, draws=None):
        with harness.annotate("fit.step"):
            state, metrics = step_fn(state, batch, gen, draws)
        kept["losses"].append(metrics["loss"])
        kept["hw"].append(tuple(batch["pixel_values"].shape[1:3]))
        if state.step == 1:
            kept["mu"] = {k: v.float().clone() for k, v in state.optimizer["mu"].items()}
        if state.step == checked:
            kept["p3"] = {k: p.detach().float().clone() for k, p in params.items()}
        return state, metrics

    trainer.step_fn = recorded_step
    source = batch_source(config, tr, seed, device)
    if "shards" in tr:  # every bucket's shapes, as the train CLI warms them
        trainer.warmup(tr["batch"], tr["text_tokens"], tr["teacher_tokens"])
    sub = harness.SubWindow(cuda) if trace else None
    clock = {"open": None, "marks": [], "wait": []}

    def mark():
        """The completion of every step queued so far: a CUDA event on the
        steps' stream, or on the CPU the host's clock."""
        if not cuda:
            return time.perf_counter()
        e = torch.cuda.Event(enable_timing=True)
        e.record()
        return e

    def feed(first: int, window: bool) -> Iterator[Dict]:
        step = first
        while True:
            if window:
                if step > first:
                    clock["marks"].append(mark())
                if time.perf_counter() - clock["open"] >= seconds:
                    sync()  # every step queued completes, the last at or after the seconds
                    return
            t_in = time.perf_counter()
            with harness.annotate("feed"):
                batch = source.next(step)
            if window:
                clock["wait"].append(time.perf_counter() - t_in)
            yield batch
            step += 1

    with harness.annotate("fit.checked"):
        trainer.fit(feed(0, False), max_steps=checked)
    sync()
    clock["open"] = time.perf_counter()
    opened = mark()
    with harness.annotate("fit.window"):
        trainer.fit(feed(checked, True), max_steps=10 ** 9)
    sync()
    done = [clock["open"] + opened.elapsed_time(m) / 1e3 if cuda else m
            for m in clock["marks"]]
    if sub is not None:  # whole steps past the window, so that profiling slows none of it
        sub.start()
        with harness.annotate("fit.traced"):
            trainer.fit(feed(trainer.host_step, False),
                        max_steps=trainer.host_step + tr["trace_steps"])
        sub.stop()
    events = [(clock["open"], 0.0)] + [(t, float(tr["batch"])) for t in done]
    t0, t1, samples = harness.window(events, seconds)
    steps_in = [t for t in done if t <= t1]
    losses = [float(v) for v in kept["losses"]]
    out = {
        "e2e": {tr.get("rate_metric", "samples_per_s"): samples / (t1 - t0),
                "setup_s": t0 - t_start},
        "attempted": len(steps_in),
        "failed": sum(1 for v in losses[checked:checked + len(steps_in)] if v != v),
        "device": harness.device_record() if cuda else {"platform": "cpu"},
        "info": {"window_s": t1 - t0, "steps_in_window": len(steps_in),
                 "losses": losses[:checked]},
    }
    ctx = {"window_s": t1 - t0, "samples": samples, "steps": len(steps_in),
           "data_wait_s": clock["wait"][:len(steps_in)], "traffic": tr, "config": config,
           "window_hw": kept["hw"][checked:checked + len(steps_in)],
           "subwindow": sub}
    if sub is not None and sub.done:
        ctx["trace"] = sub.reduce()
        ctx["trace_steps"] = tr["trace_steps"]
        ctx["trace_hw"] = kept["hw"][-tr["trace_steps"]:]
    out["ctx"] = ctx
    prog = {"losses": losses[:checked],
            "first_grad": {k: v / (1 - hp["adam_beta1"]) for k, v in kept["mu"].items()},
            "change": {k: kept["p3"][k] - kept["p0"][k] for k in params}}
    del trainer, models, params, step_fn, recorded_step, kept
    out_dir.cleanup()
    if cuda:
        torch.cuda.empty_cache()
    try:
        batches, gap = source.checked(), source.gap()
    finally:
        source.close()
    draw_seeds = [int(seed) * 1_000_003 + s for s in range(checked)]
    ref = checks.train_reference(config, hp, seed, batches, draw_seeds, device,
                                 tr["reference_chunk"])
    values = checks.train_numbers(prog, ref)
    if gap is not None:
        values["batch_gap"] = gap
    out["correct"], out["checks"] = harness.checks_report(values, lims)
    out["info"]["compared"] = values
    out["info"]["reference_losses"] = ref["losses"]
    return out
