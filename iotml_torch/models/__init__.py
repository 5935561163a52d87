from .moe import MoEBlock, MoEFFN, MoESensorFormer  # noqa: F401
