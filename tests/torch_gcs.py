"""A fake bucket for the port's ``gs://`` tests: the JAX suite's in-memory
``FakeGCS`` (``tests/test_storage.py``) installed as the process-wide GCS
client of both packages' storage modules, with ``HOME`` moved into the
test's directory so the data and registry caches (keyed by generations
that restart with every fake) start empty."""

from mlops_tpu.utils import storage as jax_storage
from mlops_tpu_torch.utils import storage
from test_storage import FakeGCS


def install_fake_bucket(monkeypatch, home) -> FakeGCS:
    fake = FakeGCS()
    monkeypatch.setenv("HOME", str(home))
    monkeypatch.delenv("GCS_ACCESS_TOKEN", raising=False)
    for module in (storage, jax_storage):
        monkeypatch.setattr(
            module, "_default_client", module.GCSClient(transport=fake.transport)
        )
    return fake
