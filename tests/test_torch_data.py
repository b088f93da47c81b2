"""The port's data names against the JAX package's: the module exports
and ``make_batch_iterator`` from a resume step, batch for batch."""
import itertools

import numpy as np

import repro.data as jax_data
import repro_torch.data as data


def test_data_package_exports_the_references_names():
    for name in ("DataConfig", "make_batch_iterator", "synthetic_batch",
                 "make_url_like_dataset"):
        assert hasattr(jax_data, name) and hasattr(data, name), name


def test_make_batch_iterator_matches_reference():
    kw = dict(global_batch=4, seq_len=16, vocab_size=512, kind="vlm",
              num_image_tokens=3, vision_dim=8)
    got = itertools.islice(data.make_batch_iterator(
        data.DataConfig(**kw), start_step=5), 3)
    want = itertools.islice(jax_data.make_batch_iterator(
        jax_data.DataConfig(**kw), start_step=5), 3)
    for step, (g, w) in enumerate(zip(got, want), start=5):
        assert g.keys() == w.keys()
        for k in g:
            np.testing.assert_array_equal(g[k], w[k])
        np.testing.assert_array_equal(
            g["tokens"], data.synthetic_batch(data.DataConfig(**kw),
                                              step)["tokens"])
