"""Whisper-small — encoder-decoder backbone; conv audio frontend is a STUB
(the batch feeds precomputed frame embeddings, `encoder_embeds`)
[arXiv:2212.04356].  Torch copy of `repro.configs.whisper_small`:
`config()` the published configuration (bfloat16), `smoke_config()` a
reduced one (float32)."""

from repro_torch.models.config import ModelConfig


def config() -> ModelConfig:
    return ModelConfig(
        name="whisper-small",
        family="encdec",
        num_layers=12,        # decoder layers
        encoder_layers=12,
        encoder_len=1500,     # 30 s of audio at 50 Hz after the conv stub
        d_model=768,
        num_heads=12,
        num_kv_heads=12,
        d_ff=3072,
        vocab_size=51865,
        pos_scheme="learned",
        max_seq=32768,        # decode_32k cell (mechanical; >> whisper's 448)
        act="gelu",
        norm="layer",
        dtype="bfloat16",
    )


def smoke_config() -> ModelConfig:
    return ModelConfig(
        name="whisper-small-smoke",
        family="encdec",
        num_layers=2,
        encoder_layers=2,
        encoder_len=12,
        d_model=48,
        num_heads=4,
        num_kv_heads=4,
        d_ff=96,
        vocab_size=256,
        pos_scheme="learned",
        max_seq=64,
        act="gelu",
        norm="layer",
        remat=False,
    )
