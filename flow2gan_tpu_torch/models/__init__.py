from flow2gan_tpu_torch.models.config import get_gan_config, get_generator_config  # noqa: F401
from flow2gan_tpu_torch.models.convnext import (  # noqa: F401
    AudioConvNeXt,
    CondEncoder,
    ConvNeXtBlock,
    ConvNeXtDecoder,
    sinusoidal_pos_emb,
)
from flow2gan_tpu_torch.models.generator import (  # noqa: F401
    FMDraws,
    MelAudioGenerator,
    RolloutDraws,
)
from flow2gan_tpu_torch.models.norms import BiasNorm, ChannelScale, PReLU  # noqa: F401

# config keys the generator is built from: the model's and its FM loss's; the
# rest (mel_n_fft, conditioning, ...) configure the frontend and the family
_MODEL_KEYS = (
    "n_ffts", "hop_lengths", "channels", "time_embed_channels", "hidden_factor",
    "conv_kernel_sizes", "num_layers", "use_cond_encoder", "n_mels",
    "mel_hop_length", "cond_enc_channels", "cond_enc_hidden_factor",
    "cond_enc_conv_kernel_size", "cond_enc_num_layers", "use_residual_scale",
    "init_noise_scale", "pred_x1", "branch_reduction", "sampling_rate",
    "spec_scaling_loss", "loss_n_filters", "loss_n_fft", "loss_hop_length",
    "loss_power", "loss_eps", "loss_scale_min", "loss_scale_max",
    "branch_dropout", "max_add_noise_scale", "compute_dtype",
)


def build_generator(config, istft_impl: str = "auto") -> MelAudioGenerator:
    """Construct the generator of a named config dict/AttributeDict.

    Parameters are left at placeholder values: load them
    (`compat.from_jax`, a `.pt` state_dict) or draw them with
    `api.init_weights`.
    """
    if config.get("conditioning", "mel") == "tokens":
        raise NotImplementedError(
            "token-conditioned generators are not ported yet (ROADMAP.md, "
            "'The token family')"
        )
    return MelAudioGenerator(**{k: config[k] for k in _MODEL_KEYS}, istft_impl=istft_impl)
