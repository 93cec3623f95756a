"""Full-resolution SEVIR VAE on the PyTorch/CUDA port: AutoencoderKL at
384² -> 4x48x48 latents (counterpart of experiments/vae_sevir384/train.py).

The reference's main VAE configuration (reference autoencoder_kl.py:80-113,
loaded from the CasCast checkpoint via helpers.py:14-32; full-res dataset
preset sevir/sevir.py:1111-1130). Same VAE-GAN task as vae_gan_kl, at the
geometry the reference actually serves, with remat on (each block
recomputed in the backward) and bf16 mixed precision. Its C=64 and C=128
GroupNorms at 384² exceed one thread-block cluster's shared memory, so the
GroupNorm kernel runs them on its two-pass path.

    python experiments_gpu/vae_sevir384/train.py dataset.sevir_dir=... \\
        dataset.use_cache=true
"""

import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__)))))

from experiments_gpu.ae_gan.train import build_task  # noqa: E402,F401

if __name__ == "__main__":
    from experiments_gpu.common import main

    main(__file__, build_task)
