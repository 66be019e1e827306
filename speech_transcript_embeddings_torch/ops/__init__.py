from speech_transcript_embeddings_torch.ops.frontend import LogMelFrontend  # noqa: F401


def make_frontend(cfg):
    """LogMelFrontend factory honouring ``FrontendConfig.use_pallas``: the
    kernel frontend (CUDA kernels for CUDA inputs) or the plain one."""
    if cfg.use_pallas:
        from speech_transcript_embeddings_torch.ops.frontend_kernels import (
            KernelLogMelFrontend,
        )
        return KernelLogMelFrontend(cfg)
    return LogMelFrontend(cfg)
