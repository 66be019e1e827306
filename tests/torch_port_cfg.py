"""Shared helpers of the port's CPU tests: the port's config built from a
JAX-package config, for the tests that feed one configuration to both
packages, and the rule that the port's tests run torch on one intra-op
thread (``one_thread``)."""

import dataclasses

import pytest
import torch

from speech_transcript_embeddings_torch import config as tconfig


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """Run the importing module's tests on one intra-op thread, restoring
    torch's setting after them.

    Importing it (``from torch_port_cfg import one_thread  # noqa: F401``)
    is enough to apply it, and a case of ``test_torch_deepseek_v2.py``
    fails a CPU ``test_torch_*.py`` module without it. The tests run in
    six xdist workers; torch's default pool in each of them oversubscribes
    the cores, and the tiny models run no slower on one thread (a 43 s
    file once took 735 s in the suite; the depthwise GLU tests take 7.7 s
    alone and 582 worker-seconds in the suite at the default pool)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def port_cfg(cfg):
    """The port's dataclass of the same name as ``cfg`` (a JAX-package
    config), with the same field values, nested configs converted too."""
    values = {}
    for f in dataclasses.fields(cfg):
        v = getattr(cfg, f.name)
        values[f.name] = port_cfg(v) if dataclasses.is_dataclass(v) else v
    return getattr(tconfig, type(cfg).__name__)(**values)
