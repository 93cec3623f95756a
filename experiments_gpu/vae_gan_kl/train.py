"""VAE-KL + PatchGAN (LPIPSWithDiscriminator semantics) on the
PyTorch/CUDA port: the ae_gan task with kl_weight set (counterpart of
experiments/vae_gan_kl/train.py; reference
experiments/v1_experiments/ae_gan_kl/train.py plus
autoencoderkl/losses/contperceptual.py:33-169). Its config trains
AutoencoderKL(64, 128, 256, 512) at 128², every GroupNorm on the Hopper
GroupNorm+SiLU kernel on the card.

    python experiments_gpu/vae_gan_kl/train.py dataset.sevir_dir=... \\
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
