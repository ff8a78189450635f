"""Hold the JAX package to its host labelers (scipy and numpy) in the port's
tests.

The JAX package links its native union-find straight onto its final path
(``delivr_cfos_tpu/native/build.py``): workers that build it at once under
xdist can load a half-written library (ROADMAP.md §3). The port's tests run
the JAX stages with its native labeler and statistics answering None, which
the JAX package handles by taking ``label_volume_host`` and
``component_statistics`` (the same canonical labels and statistics,
``tests/test_torch_connected_components.py``). Importing the fixture into a
test module applies it to every test there."""

import pytest


@pytest.fixture(autouse=True)
def jax_host_labelers(monkeypatch):
    import delivr_cfos_tpu.native.cc as jcc
    import delivr_cfos_tpu.pipeline.stage03_count_blobs as j3
    import delivr_cfos_tpu.pipeline.stage06_visualization as j6

    for mod in (jcc, j3, j6):
        monkeypatch.setattr(mod, "cc_label_native", lambda *a, **k: None)
        monkeypatch.setattr(mod, "cc_statistics_native", lambda *a, **k: None)
