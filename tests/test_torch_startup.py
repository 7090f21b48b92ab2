"""The port's start-up module (pea_diffusion_tpu_torch/utils/startup.py):
the compile cache moves both libraries' builds and nothing else, refuses to
move a library already loaded, and falls back to the user's cache where the
checkout cannot be written; the native reader builds into it; aot_key and
AOTCache; device_put_streamed to the CPU and its thread's exception at
join(); prefetch on a CPU pipeline does nothing; and
tools/bench_startup.py end to end on the tiny stack written as a
deployment. There is no nvcc here, so the kernel library's build is
checked by its paths only."""
import dataclasses
import json
import os
from pathlib import Path

import pytest
import torch

import _torch_dirs as dirs
from _torch_parity import one_torch_thread  # noqa: F401
from pea_diffusion_tpu_torch.cli.generate import build_demo
from pea_diffusion_tpu_torch.data import native_reader
from pea_diffusion_tpu_torch.ops import kernel_build
from pea_diffusion_tpu_torch.pipelines import StableDiffusionXLPEAPipeline
from pea_diffusion_tpu_torch.utils import startup


@pytest.fixture(autouse=True)
def restore_build_dirs(monkeypatch):
    """Every test here leaves the libraries' build directories and the
    loaded-library tables as it found them."""
    monkeypatch.setattr(kernel_build, "BUILD_DIR", kernel_build.BUILD_DIR)
    monkeypatch.setattr(native_reader, "BUILD_DIR", native_reader.BUILD_DIR)
    monkeypatch.setattr(kernel_build, "_functions", dict(kernel_build._functions))
    monkeypatch.setattr(kernel_build, "_library", kernel_build._library)


def test_compile_cache_moves_both_libraries_and_nothing_else(tmp_path):
    kernels, reader = kernel_build.library_path(), native_reader.library_path()
    flags = (kernel_build.NVCC_FLAGS, kernel_build.CSRC, native_reader.CXX_FLAGS,
             native_reader.SOURCE)
    assert startup.enable_compile_cache(str(tmp_path)) == str(tmp_path.resolve())
    assert kernel_build.library_path() == tmp_path.resolve() / "kernels" / kernels.name
    assert native_reader.library_path() == tmp_path.resolve() / "native" / reader.name
    assert flags == (kernel_build.NVCC_FLAGS, kernel_build.CSRC, native_reader.CXX_FLAGS,
                     native_reader.SOURCE)
    assert startup.enable_compile_cache(str(tmp_path)) == str(tmp_path.resolve())  # again


def test_default_cache_is_the_checkout_build_dir_or_the_users(monkeypatch):
    assert startup.default_cache_dir() == startup.CHECKOUT_BUILD
    assert Path(startup.enable_compile_cache()) / "kernels" == Path(kernel_build.BUILD_DIR)
    assert Path(kernel_build.BUILD_DIR) == startup.CHECKOUT_BUILD / "kernels"
    monkeypatch.setattr(os, "access", lambda path, mode: False)
    assert startup.default_cache_dir() == Path(os.path.expanduser(
        "~/.cache/pea_diffusion_tpu_torch"))


def test_compile_cache_leaves_a_loaded_kernel_library_alone(tmp_path, monkeypatch):
    """Once this process has loaded the kernel library, every launcher comes
    from it, wherever the compile cache points afterwards: nothing is built
    or loaded again."""
    class Library:
        def __getattr__(self, symbol):
            def fn(*args):
                return 0
            return fn

    monkeypatch.setattr(kernel_build, "_library", Library())
    monkeypatch.setattr(kernel_build, "build", lambda: pytest.fail("built again"))
    startup.enable_compile_cache(str(tmp_path / "elsewhere"))
    assert kernel_build.library_path().parent == (tmp_path / "elsewhere").resolve() / "kernels"
    kernel_build.launch("pea_some_launcher", [])
    assert "pea_some_launcher" in kernel_build._functions


def test_native_reader_builds_into_the_cache(tmp_path):
    startup.enable_compile_cache(str(tmp_path))
    path = native_reader.build()
    assert path.parent == tmp_path.resolve() / "native" and path.is_file()


def test_no_compile_cache_builds_into_a_fresh_directory():
    root = Path(startup.temporary_compile_cache())
    try:
        assert root.is_dir() and not any(root.iterdir())
        assert kernel_build.library_path().parent == root / "kernels"
        assert Path(startup.temporary_compile_cache()) != root
    finally:
        os.rmdir(root)


def test_aot_key_is_stable_and_differs_by_parts():
    key = startup.aot_key("sdxl", (1, 52), 1024)
    assert key == startup.aot_key("sdxl", (1, 52), 1024) and len(key) == 24
    int(key, 16)
    assert len({key, startup.aot_key("sdxl", (1, 52), 512), startup.aot_key("sdxl", (2, 52),
                                                                             1024)}) == 3


def test_aot_cache_keeps_the_libraries_under_a_keyed_directory(tmp_path):
    cache = startup.AOTCache(str(tmp_path))
    assert Path(cache.root).parent == tmp_path.resolve() and len(Path(cache.root).name) == 24
    assert kernel_build.library_path().parent == Path(cache.root) / "kernels"
    assert native_reader.library_path().parent == Path(cache.root) / "native"
    assert not cache.warm()
    kernel_build.library_path().parent.mkdir(parents=True)
    kernel_build.library_path().write_bytes(b"")
    assert cache.warm() and startup.AOTCache(str(tmp_path)).root == cache.root


def test_device_put_streamed_to_the_cpu():
    models, _, _ = build_demo("cpu")
    sd = models.vae.state_dict()
    placed = startup.device_put_streamed(sd, "cpu", chunk_leaves=3)()
    assert list(placed) == list(sd) and all(torch.equal(placed[k], sd[k]) for k in sd)
    want = {k: v.clone() for k, v in models.unet.state_dict().items()}
    unet = startup.device_put_streamed(models.unet, "cpu", chunk_leaves=5)()
    assert unet is models.unet
    got = unet.state_dict()
    assert list(got) == list(want) and all(torch.equal(got[k], want[k]) for k in want)


def test_device_put_streamed_raises_at_join():
    class Bad:
        def detach(self):
            raise ValueError("unreadable weight")

    join = startup.device_put_streamed({"a": torch.ones(2), "b": Bad()}, "cpu")
    with pytest.raises(ValueError, match="unreadable weight"):
        join()


def test_prefetch_on_a_cpu_pipeline_does_nothing():
    models, _, _ = build_demo("cpu")
    loaded = dict(kernel_build._functions)
    assert StableDiffusionXLPEAPipeline(models, "ddim").prefetch(1, 16, height=64,
                                                                 width=64) == ()
    assert kernel_build._functions == loaded
    assert startup.launcher_symbols({"onepass", "flash", "plain"}, False).keys() == {
        "pea_onepass_attention_fwd", "pea_flash_attention_fwd"}
    assert set(startup.launcher_symbols({"plain"}, True)) == {
        "pea_group_norm_fwd", "pea_group_norm_bias_fwd", "pea_gn_shipped_variant"}


def test_unet_attention_routes_follow_the_dispatch():
    """At SDXL's 1024² latents the serving UNet's attention takes the
    one-pass kernel (self) and the flash kernel (cross) on a CUDA tensor."""
    from pea_diffusion_tpu_torch.configs import SDXL_UNET
    from pea_diffusion_tpu_torch.models import UNet2DCondition

    with torch.device("meta"):
        unet = UNet2DCondition(SDXL_UNET)
    assert startup.unet_attention_routes(unet, 128, 128, 52) == {"onepass", "flash"}


def test_bench_startup_on_the_tiny_stack(tmp_path, monkeypatch, capsys):
    from pea_diffusion_tpu_torch.checkpoints.orbax_io import export_adapter
    from pea_diffusion_tpu_torch.configs.adapter import ADAPTER_PRESETS
    from pea_diffusion_tpu_torch.tools import bench_startup

    models, _, _ = build_demo("cpu")
    root = tmp_path / "deployment"
    dirs.write_model_dir(root, dirs.SDXL_UNET_JSON, models.unet.state_dict(),
                         models.vae.state_dict())
    dirs.write_text_dir(str(root / "text"), models.text_encoder.state_dict())
    export_adapter(models.adapter, str(root), 0)
    monkeypatch.setitem(ADAPTER_PRESETS, "tiny", dataclasses.replace(
        ADAPTER_PRESETS["sdxl_small"], in_dim=64, projector_dims=(96, 64),
        projector_bias=False, head_dim=64))
    argv = ["--model-dir", str(root), "--aot-cache", str(tmp_path / "aot"), "--device", "cpu",
            "--adapter-preset", "tiny", "--max-length", "16", "--size", "64", "--steps", "2"]
    for extra in ([], ["--serial"]):
        assert bench_startup.main(argv + extra) == 0
        res = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
        phases = res["detail"]["phases_s"]
        want = ["import", "cuda_init", "load"] + (
            ["place", "prefetch"] if extra else ["_prefetch_part", "place_and_prefetch"]) + [
            "first_image", "second_image"]
        assert list(phases) == want and all(v >= 0 for v in phases.values())
        assert res["value"] == pytest.approx(sum(
            v for k, v in phases.items() if k not in ("_prefetch_part", "second_image")))
        assert res["detail"]["image_ok"] and res["detail"]["image_shape"] == [1, 16, 16, 3]
        assert res["detail"]["launchers"] == [] and res["detail"]["kernel_library"] == "cold"
