from flow2gan_tpu_torch.models.config import get_gan_config, get_generator_config  # noqa: F401
from flow2gan_tpu_torch.models.convnext import (  # noqa: F401
    AudioConvNeXt,
    CondEncoder,
    ConvNeXtBlock,
    ConvNeXtDecoder,
    sinusoidal_pos_emb,
)
from flow2gan_tpu_torch.models.generator import (  # noqa: F401
    BaseAudioGenerator,
    FMDraws,
    MelAudioGenerator,
    RolloutDraws,
    TokenAudioGenerator,
)
from flow2gan_tpu_torch.models.norms import BiasNorm, ChannelScale, PReLU  # noqa: F401

# config keys every generator is built from: the model's and its FM loss's;
# the rest (mel_n_fft, conditioning, ...) configure the frontend and the family
_MODEL_KEYS = (
    "n_ffts", "hop_lengths", "channels", "time_embed_channels", "hidden_factor",
    "conv_kernel_sizes", "num_layers", "use_cond_encoder", "cond_enc_channels",
    "cond_enc_hidden_factor", "cond_enc_conv_kernel_size", "cond_enc_num_layers",
    "use_residual_scale", "init_noise_scale", "pred_x1", "branch_reduction", "sampling_rate",
    "spec_scaling_loss", "loss_n_filters", "loss_n_fft", "loss_hop_length",
    "loss_power", "loss_eps", "loss_scale_min", "loss_scale_max",
    "branch_dropout", "compute_dtype",
)


def build_generator(config) -> BaseAudioGenerator:
    """Construct the generator of a named config dict/AttributeDict.

    `conditioning: "tokens"` builds a `TokenAudioGenerator` (ids of the
    k-means pseudo-codec, `ops/tokenizer.py`), whose embedding is
    `cond_embed_dim` wide; the mel_* keys of a token config describe its
    tokenizer's frontend, and only the hop is the model's. The default
    builds the mel-conditioned `MelAudioGenerator`.

    Parameters are left at placeholder values: load them
    (`compat.from_jax`, a `.pt` state_dict) or draw them with
    `api.init_weights`.
    """
    common = {k: config[k] for k in _MODEL_KEYS}
    conditioning = config.get("conditioning", "mel")
    if conditioning == "tokens":
        return TokenAudioGenerator(vocab_size=config["vocab_size"], cond_dim=config["cond_embed_dim"],
                                   token_hop_length=config["mel_hop_length"], **common)
    if conditioning != "mel":
        raise ValueError(f"unknown conditioning: {conditioning!r}")
    return MelAudioGenerator(n_mels=config["n_mels"], mel_hop_length=config["mel_hop_length"],
                             max_add_noise_scale=config["max_add_noise_scale"], **common)
