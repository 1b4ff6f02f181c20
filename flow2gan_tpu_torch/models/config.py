"""Named model configurations: a copy of the registry in
`flow2gan_tpu/models/config.py` (that module imports the JAX package's
utils, so the port keeps its own)."""

from __future__ import annotations

from flow2gan_tpu_torch.utils import AttributeDict

mel_24k_base = {
    "sampling_rate": 24000,
    "n_mels": 100,
    "mel_n_fft": 1024,
    "mel_hop_length": 256,
    "n_ffts": (512, 256, 128),
    "hop_lengths": (256, 128, 64),
    "channels": (768, 512, 384),
    "time_embed_channels": 512,
    "hidden_factor": 3,
    "conv_kernel_sizes": (7, 7, 7),
    "num_layers": (8, 8, 8),
    "use_cond_encoder": True,
    "cond_enc_channels": 512,
    "cond_enc_hidden_factor": 3,
    "cond_enc_conv_kernel_size": 7,
    "cond_enc_num_layers": 4,
    "use_residual_scale": True,
    "init_noise_scale": 0.1,
    "pred_x1": True,
    "branch_reduction": "mean",
    "spec_scaling_loss": True,
    "loss_n_filters": 256,
    "loss_n_fft": 1024,
    "loss_hop_length": 256,
    "loss_power": 0.5,
    "loss_eps": 1e-7,
    "loss_scale_min": 1e-2,
    "loss_scale_max": 1e2,
    "branch_dropout": 0.05,
    "max_add_noise_scale": 0.0,
    # the ConvNeXt stacks' compute dtype: None (float32) or "bfloat16"; the
    # parameters stay float32 (the JAX package's `compute_dtype` field)
    "compute_dtype": None,
}

mel_44k_128band_512x_base = {
    **mel_24k_base,
    "sampling_rate": 44100,
    "n_mels": 128,
    "mel_n_fft": 2048,
    "mel_hop_length": 512,
    "n_ffts": (1024, 512, 256),
    "hop_lengths": (512, 256, 128),
    "loss_n_fft": 2048,
    "loss_hop_length": 512,
}

# small config for fast tests / examples (not in the reference registry)
mel_24k_tiny = {
    **mel_24k_base,
    "n_ffts": (128, 64),
    "hop_lengths": (64, 32),
    "channels": (64, 48),
    "time_embed_channels": 32,
    "conv_kernel_sizes": (7, 7),
    "num_layers": (2, 2),
    "cond_enc_channels": 48,
    "cond_enc_num_layers": 2,
    "n_mels": 20,
    "mel_n_fft": 256,
    "mel_hop_length": 64,
    "loss_n_filters": 64,
    "loss_n_fft": 256,
    "loss_hop_length": 64,
}

# Discrete-token-conditioned family: `conditioning: "tokens"` swaps the mel
# frontend for the k-means pseudo-codec (`ops/tokenizer.py`,
# `bin/train_tokenizer.py`); the mel_* keys describe the tokenizer's frontend,
# checked against the codebook file at load.
token_24k_base = {
    **mel_24k_base,
    "conditioning": "tokens",
    "vocab_size": 1024,
    "cond_embed_dim": 256,
}

token_24k_tiny = {
    **mel_24k_tiny,
    "conditioning": "tokens",
    "vocab_size": 64,
    "cond_embed_dim": 24,
}

_GENERATOR_CONFIGS = {
    "mel_24k_base": mel_24k_base,
    "mel_44k_128band_512x_base": mel_44k_128band_512x_base,
    "mel_24k_tiny": mel_24k_tiny,
    "token_24k_base": token_24k_base,
    "token_24k_tiny": token_24k_tiny,
}


# The released checkpoints: model name -> the n_timesteps its GAN stage was
# tuned for. They live in HF_REPO as <name>.pt; the port downloads nothing.
HF_REPO = "k2-fsa/Flow2GAN"
HF_MODEL_NAMES = {
    "libritts-mel-1-step": 1,
    "libritts-mel-2-step": 2,
    "libritts-mel-4-step": 4,
    "universal-24k-mel-1-step": 1,
    "universal-24k-mel-2-step": 2,
    "universal-24k-mel-4-step": 4,
    "universal-44k-mel-128band-512x-1-step": 1,
    "universal-44k-mel-128band-512x-2-step": 2,
    "universal-44k-mel-128band-512x-4-step": 4,
}


def generator_config_for_hf_model(hf_model_name: str) -> str:
    if "44k" in hf_model_name:
        return "mel_44k_128band_512x_base"
    return "mel_24k_base"


def get_generator_config(model_name: str = "mel_24k_base") -> AttributeDict:
    if model_name not in _GENERATOR_CONFIGS:
        raise ValueError(
            f"Unsupported model name: {model_name}; "
            f"available: {sorted(_GENERATOR_CONFIGS)}"
        )
    return AttributeDict(_GENERATOR_CONFIGS[model_name])


# the GAN stage's multi-scale mel reconstruction loss: n_fft and mel count of
# each scale (hop n_fft // 4)
gan_multi_scale_mel_recon = {
    "mel_recon_n_ffts": (32, 64, 128, 256, 512, 1024, 2048),
    "mel_recon_n_mels": (5, 10, 20, 40, 80, 160, 320),
}

gan_single_scale_mel_recon = {
    "mel_recon_n_ffts": (1024,),
    "mel_recon_n_mels": (100,),
}

_GAN_CONFIGS = {
    "gan_multi_scale_mel_recon": gan_multi_scale_mel_recon,
    "gan_single_scale_mel_recon": gan_single_scale_mel_recon,
}


def get_gan_config(model_name: str) -> AttributeDict:
    if model_name not in _GAN_CONFIGS:
        raise ValueError(
            f"Unsupported model name: {model_name}; available: {sorted(_GAN_CONFIGS)}"
        )
    return AttributeDict(_GAN_CONFIGS[model_name])
