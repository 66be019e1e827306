"""The port's config built from a JAX-package config, for the tests that
feed one configuration to both packages."""

import dataclasses

from speech_transcript_embeddings_torch import config as tconfig


def port_cfg(cfg):
    """The port's dataclass of the same name as ``cfg`` (a JAX-package
    config), with the same field values, nested configs converted too."""
    values = {}
    for f in dataclasses.fields(cfg):
        v = getattr(cfg, f.name)
        values[f.name] = port_cfg(v) if dataclasses.is_dataclass(v) else v
    return getattr(tconfig, type(cfg).__name__)(**values)
