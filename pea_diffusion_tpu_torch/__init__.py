"""PyTorch/CUDA port of pea_diffusion_tpu for NVIDIA Hopper (H100).

The JAX package ``pea_diffusion_tpu`` is the reference this package is
tested against; this package imports none of it. Its layout mirrors the JAX
package, so each module's counterpart has the same path:

configs/      the dataclass configs and presets the port runs
models/       nn.Modules with diffusers/transformers parameter names:
              PEA adapter, Chinese-CLIP BERT tower, CLIP teacher towers,
              SDXL UNet, VAE
ops/          attention dispatch, the hand-written Hopper kernels (B1
              one-pass, B3 flash forward, B4/B5 flash backward) with their
              plain versions, and the autograd Functions over them
csrc/         the kernels' CUDA sources (built with nvcc at first use)
schedulers/   DDIM, DPM-Solver++, Euler, Euler-ancestral and LCM tables and
              steps, DDPM add_noise and its ancestral step
pipelines/    SD1.5 and SDXL text-to-image, SDXL ControlNet, the sampler
              interface, model factories
train/        KD loss and train step, the optax-equivalent optimizer,
              the trainer (checkpoints, resume, adapter export)
checkpoints/  weights from disk: safetensors, diffusers/transformers
              directories, LoRA fusion, the reference adapter format; and
              the JAX parameter tree -> the port's state dicts
utils/        the JSONL metric log
parallel/     multi-GPU: process-group start-up, the (data, fsdp) meshes
              and FSDP2 rule for KD training, Megatron tensor parallelism
              of the UNet for serving
cli/          the generate, serve, train and evaluate CLIs

Entry points run on the card (``device="cuda"``) unless the caller asks
for the CPU; on the CPU each kernel wrapper runs its plain version.
"""

__version__ = "0.1.0"
