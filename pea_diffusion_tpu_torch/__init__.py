"""PyTorch/CUDA port of pea_diffusion_tpu for NVIDIA Hopper (H100).

The JAX package ``pea_diffusion_tpu`` is the reference this package is
tested against; this package imports none of it. Its layout mirrors the JAX
package, so each module's counterpart has the same path:

configs/      the dataclass configs and presets the port runs
models/       nn.Modules with diffusers/transformers parameter names:
              PEA adapter, Chinese-CLIP BERT tower, SDXL UNet, VAE
ops/          attention dispatch and the hand-written Hopper kernels
              (B1 one-pass, B3 flash forward) with their plain versions
csrc/         the kernels' CUDA sources (built with nvcc at first use)
schedulers/   DDIM and DPM-Solver++ tables and steps
pipelines/    SDXL text-to-image, sampler interface, model factory
checkpoints/  the JAX parameter tree -> the port's state dicts
cli/          the generate CLI

Entry points run on the card (``device="cuda"``) unless the caller asks
for the CPU; on the CPU each kernel wrapper runs its plain version.
"""

__version__ = "0.1.0"
