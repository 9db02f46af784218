"""The port's token pipeline (``repro_torch/data/pipeline.py``) against
the JAX package's (``repro/data/pipeline.py``) on the CPU: every batch is
bit-equal to the reference's (both draw from ``np.random.default_rng((seed,
step))``), for the synthetic and file kinds and the vision and audio
frontends, and the prefetching stream resumes at a step."""

import dataclasses
import itertools

import numpy as np
import pytest
import torch

from repro.data import pipeline as r_pipe
from repro_torch.data import pipeline as t_pipe

KINDS = {
    "synthetic": dict(),
    "vocab_1000": dict(vocab_size=1000, batch=3, seq_len=33),
    "vision": dict(frontend="vision_patches", d_model=8, vis_tokens=5),
    "audio": dict(frontend="audio_frames", d_model=8, seq_len=64,
                  dec_ratio=8),
}


def configs(**kw):
    return r_pipe.DataConfig(seed=7, **kw), t_pipe.DataConfig(seed=7, **kw)


def equal(got, want):
    assert set(got) == set(want)
    for k in want:
        g = got[k].numpy() if torch.is_tensor(got[k]) else got[k]
        assert g.dtype == want[k].dtype, k
        np.testing.assert_array_equal(g, want[k], err_msg=k)


@pytest.mark.parametrize("kind", list(KINDS))
def test_make_batch_bit_equal(kind):
    rc, tc = configs(**KINDS[kind])
    for step in (0, 1, 5, 123):
        equal(t_pipe.make_batch(tc, step), r_pipe.make_batch(rc, step))


@pytest.fixture
def token_file(tmp_path):
    path = tmp_path / "tokens.bin"
    np.random.default_rng(0).integers(0, 60_000, 5_000).astype(
        np.uint16).tofile(path)
    return str(path)


def test_file_kind_bit_equal(token_file):
    rc, tc = configs(kind="file", path=token_file, vocab_size=512, batch=4,
                     seq_len=32)
    want = list(itertools.islice(r_pipe.synthetic_batches(rc, 2), 3))
    got = list(itertools.islice(t_pipe.synthetic_batches(tc, 2), 3))
    for g, w in zip(got, want):
        equal(g, w)
    # labels are the tokens shifted by one, both from the file
    arr = t_pipe.load_tokens(tc)
    assert arr.max() < 512
    np.testing.assert_array_equal(got[0]["tokens"][:, 1:],
                                  got[0]["labels"][:, :-1])
    with pytest.raises(ValueError, match="token array"):
        t_pipe.make_batch(tc, 0)


@pytest.mark.parametrize("kind", ["synthetic", "audio"])
def test_pipeline_resumes_at_step(kind):
    """The prefetched device stream from step 5 yields the reference's
    batches 5, 6, 7 as tensors on the device asked for."""
    rc, tc = configs(**KINDS[kind])
    pipe = t_pipe.make_pipeline(tc, device="cpu", start_step=5, prefetch=2)
    try:
        for step in range(5, 8):
            got = next(pipe)
            assert all(torch.is_tensor(v) and v.device.type == "cpu"
                       for v in got.values())
            equal(got, r_pipe.make_batch(rc, step))
    finally:
        pipe.close()


def test_pipeline_surfaces_worker_errors(tmp_path):
    _, tc = configs(kind="file", path=str(tmp_path / "missing.bin"))
    pipe = t_pipe.make_pipeline(tc, device="cpu")
    with pytest.raises(FileNotFoundError):
        next(pipe)


def test_pipeline_defaults_to_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        t_pipe.make_pipeline(t_pipe.DataConfig())


def test_config_fields_match_reference():
    assert [f.name for f in dataclasses.fields(t_pipe.DataConfig)] == \
        [f.name for f in dataclasses.fields(r_pipe.DataConfig)]
    assert t_pipe.DataConfig() == t_pipe.DataConfig(
        **dataclasses.asdict(r_pipe.DataConfig()))
