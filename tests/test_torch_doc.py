"""The port's long-context doc path against the JAX package's, on the CPU.

Small doc models (token_dim 16, 2 heads, depth 2) at doc_records 3
(S = 140, at or above the flash threshold) and 2 (S = 94, dense), with
weights from the JAX model's ``init`` and inputs made by numpy from a
seed. Tolerances:

- tokens: exact;
- the params codec: bit for bit both ways, and the port's encoding is
  byte for byte flax's;
- logits against ``model.apply``: f32 1e-5 (measured worst 3.6e-7, the
  same f32 arithmetic in another summation order); bf16 1.2e-2 (measured
  worst 0.0078125, two bf16 ulps at |logit| in [0.5, 1): the two
  frameworks round bf16 intermediates at other places, and the head's
  logit is itself rounded to bf16);
- ``predict-file`` output: equal counts; predictions within 2e-6 in f32
  (one unit of the 6-place rounding plus summation order) and 1.2e-2 in
  bf16 (the logit tolerance; the sigmoid's slope is at most 1/4).
"""

import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax import serialization

from mlops_tpu.bundle import load_bundle as jax_load_bundle
from mlops_tpu.bundle import save_bundle as jax_save_bundle
from mlops_tpu.cli import main as jax_main
from mlops_tpu.config import ModelConfig as JaxModelConfig
from mlops_tpu.data import Preprocessor as JaxPreprocessor
from mlops_tpu.data import generate_synthetic as jax_synthetic
from mlops_tpu.data import write_csv_columns as jax_write_csv
from mlops_tpu.models import bert as jax_bert
from mlops_tpu.monitor.state import fit_monitor as jax_fit_monitor
from mlops_tpu.train.long_context import build_doc_model as jax_build_doc_model
from mlops_tpu_torch.bundle import load_bundle, msgpack, save_doc_bundle, save_quant_bundle
from mlops_tpu_torch.cli import main
from mlops_tpu_torch.config import ModelConfig
from mlops_tpu_torch.data import Preprocessor, generate_synthetic
from mlops_tpu_torch.models import bert, init_params
from mlops_tpu_torch.models.layers import MultiHeadSelfAttention
from mlops_tpu_torch.monitor.state import fit_monitor
from mlops_tpu_torch.ops import attention
from mlops_tpu_torch.ops.quant import init_quant_master, quantize_student
from mlops_tpu_torch.schema.features import SCHEMA
from mlops_tpu_torch.train.long_context import build_doc_model
from mlops_tpu_torch.weights import doc_params_from_numpy, load_params
from torch_threads import torch_threads  # noqa: F401  (2 intra-op threads)

LOGIT_TOL = {"f32": 1e-5, "bf16": 1.2e-2}
PRED_TOL = {"f32": 2e-6, "bf16": 1.2e-2}


def _config(doc_records, precision):
    return dict(
        family="bert", doc_records=doc_records, token_dim=16, heads=2,
        depth=2, precision=precision,
    )


def _docs(n, r, seed):
    rng = np.random.default_rng(seed)
    cat = np.stack(
        [rng.integers(0, card, (n, r)) for card in SCHEMA.cards], axis=-1
    ).astype(np.int32)
    num = rng.normal(size=(n, r, SCHEMA.num_numeric)).astype(np.float32)
    return cat, num


def _jax_params(kw, seed=1):
    model = jax_build_doc_model(JaxModelConfig(**kw))
    cat, num = _docs(2, kw["doc_records"], 0)
    params = model.init(
        {"params": jax.random.PRNGKey(seed)}, jnp.asarray(cat), jnp.asarray(num),
        train=False,
    )["params"]
    return model, params


def _port_model(kw, params):
    model = build_doc_model(ModelConfig(**kw))
    tree = jax.tree_util.tree_map(np.asarray, params)
    return load_params(model, doc_params_from_numpy(tree, "cpu")).eval()


def _bits(x):
    if isinstance(x, torch.Tensor):
        if x.dtype == torch.bfloat16:
            return x.view(torch.int16).numpy().tobytes(), tuple(x.shape)
        return x.numpy().tobytes(), tuple(x.shape)
    x = np.asarray(x)
    return x.tobytes(), x.shape


# ------------------------------------------------------------------ codec
@pytest.mark.parametrize("precision", ["f32", "bf16"])
def test_codec_reads_flax_bytes_bit_for_bit(precision):
    _, params = _jax_params(_config(3, precision))
    tree = {
        "params": params,
        "bf16": jnp.asarray(np.linspace(-3, 3, 7), jnp.bfloat16),
        "i32": np.arange(-40, 300, dtype=np.int32),
    }
    decoded = msgpack.unpackb(serialization.to_bytes(tree))
    want = jax.tree_util.tree_leaves_with_path(tree)
    flat = {jax.tree_util.keystr(k): v for k, v in want}
    got = {
        jax.tree_util.keystr(k): v
        for k, v in jax.tree_util.tree_leaves_with_path(decoded)
    }
    assert set(got) == set(flat)
    for name, leaf in flat.items():
        assert _bits(got[name]) == _bits(leaf), name
    assert got["['bf16']"].dtype == torch.bfloat16


def test_flax_reads_the_port_encoding_bit_for_bit():
    _, params = _jax_params(_config(3, "f32"))
    tree = jax.tree_util.tree_map(np.asarray, params)
    tree["extra"] = {"bf16": np.asarray(jnp.asarray([1.5, -2.25], jnp.bfloat16))}
    tree = dict(sorted(tree.items()))  # a flax tree's order (tree_map sorts)
    encoded = msgpack.packb(tree)
    assert encoded == serialization.to_bytes(tree)
    restored = serialization.msgpack_restore(encoded)
    for (path, leaf), (_, back) in zip(
        jax.tree_util.tree_leaves_with_path(tree),
        jax.tree_util.tree_leaves_with_path(restored),
    ):
        assert _bits(back) == _bits(leaf), jax.tree_util.keystr(path)
    # Tensor leaves (the port's own params) encode to the same bytes.
    torch_tree = jax.tree_util.tree_map(lambda a: msgpack.unpackb(msgpack.packb(a)), tree)
    assert msgpack.packb(torch_tree) == encoded


@pytest.mark.parametrize(
    "value", [{"x": 1.5}, {"x": None}, {"x": True}, {1: np.zeros(2, np.float32)}]
)
def test_codec_refuses_what_a_param_tree_never_holds(value):
    with pytest.raises(ValueError):
        msgpack.unpackb(serialization.msgpack_serialize(value))
    with pytest.raises(ValueError):
        msgpack.packb(value)


# ----------------------------------------------------------------- tokens
@pytest.mark.parametrize("doc_records", [2, 3, 11])
def test_tokens_equal_the_jax_tokens(doc_records):
    cat, num = _docs(6, doc_records, seed=doc_records)
    layout = jax_bert.TokenLayout(tuple(SCHEMA.cards), SCHEMA.num_numeric, 32)
    edges = layout.bin_edges()
    # Values exactly on the bin edges exercise searchsorted's side="right".
    num.reshape(-1)[: edges.size] = edges
    want = np.asarray(
        jax_bert.tokenize_documents(jnp.asarray(cat), jnp.asarray(num), layout)
    )
    port_layout = bert.TokenLayout(tuple(SCHEMA.cards), SCHEMA.num_numeric, 32)
    got = bert.tokenize_documents(torch.from_numpy(cat), torch.from_numpy(num), port_layout)
    assert port_layout.vocab_size == layout.vocab_size
    assert np.array_equal(port_layout.bin_edges(), edges)
    assert got.shape == want.shape == (6, 2 + 46 * doc_records)
    assert np.array_equal(got.numpy(), want)


# ----------------------------------------------------------------- logits
@pytest.mark.parametrize("precision", ["f32", "bf16"])
@pytest.mark.parametrize("doc_records", [3, 2])
def test_logits_match_the_flax_apply(doc_records, precision):
    kw = _config(doc_records, precision)
    jax_model, params = _jax_params(kw)
    cat, num = _docs(8, doc_records, seed=10 + doc_records)
    want = np.asarray(
        jax_model.apply({"params": params}, jnp.asarray(cat), jnp.asarray(num),
                        train=False)
    )
    model = _port_model(kw, params)
    before = attention.flash_kernel_launches.value
    with torch.inference_mode():
        got = model(torch.from_numpy(cat), torch.from_numpy(num))
        # The flash route's plain version inside the model gives the same
        # logits (JAX's attend stays dense off the TPU).
        for mod in model.modules():
            if isinstance(mod, MultiHeadSelfAttention):
                mod.use_flash = True
        forced = model(torch.from_numpy(cat), torch.from_numpy(num))
    assert attention.flash_kernel_launches.value == before
    assert got.dtype == torch.float32 and got.shape == (8,)
    assert np.abs(got.numpy() - want).max() <= LOGIT_TOL[precision]
    assert np.abs(forced.numpy() - want).max() <= LOGIT_TOL[precision]


def test_a_param_tree_that_does_not_match_is_refused():
    kw = _config(3, "f32")
    _, params = _jax_params(kw)
    tree = jax.tree_util.tree_map(np.asarray, params)
    model = build_doc_model(ModelConfig(**kw))
    short = dict(tree)
    del short["pooler"]
    with pytest.raises(ValueError, match="missing"):
        load_params(model, doc_params_from_numpy(short, "cpu"))
    wide = _jax_params(_config(2, "f32"))[1]  # pos_embed is 94 rows, not 140
    with pytest.raises(ValueError, match="pos_embed"):
        load_params(model, doc_params_from_numpy(wide, "cpu"))


# ---------------------------------------------------------------- bundles
@pytest.fixture(scope="module")
def fitted():
    columns, _ = jax_synthetic(600, seed=0)
    return columns


@pytest.fixture(scope="module")
def history_csv(tmp_path_factory):
    path = tmp_path_factory.mktemp("doc_history") / "history.csv"
    columns, labels = jax_synthetic(3 * 11 + 2, seed=5)  # 11 docs + 2 rows
    jax_write_csv(path, columns, labels)
    return path


def _jax_bundle(directory, kw, columns):
    _, params = _jax_params(kw, seed=2)
    prep = JaxPreprocessor.fit(columns)
    jax_save_bundle(
        directory, JaxModelConfig(**kw), params, prep,
        jax_fit_monitor(prep.encode(columns)),
        calibration={"temperature": 1.3},
    )
    return directory


def _run(entry, argv, capsys):
    capsys.readouterr()
    assert entry(argv) == 0
    return json.loads(capsys.readouterr().out.strip().splitlines()[-1])


def _predict_args(csv, bundle_dir):
    return [
        "predict-file", f"data.train_path={csv}",
        f"serve.model_directory={bundle_dir}", "serve.max_batch=4",
    ]


def _assert_same(got, want, precision):
    for key in ("documents", "records_per_document", "rows_dropped"):
        assert got[key] == want[key], key
    assert len(got["predictions"]) == want["documents"]
    gap = np.abs(np.asarray(got["predictions"]) - np.asarray(want["predictions"]))
    assert gap.max() <= PRED_TOL[precision]


@pytest.mark.parametrize("precision", ["f32", "bf16"])
def test_port_predict_file_prints_what_jax_prints(
    tmp_path, fitted, history_csv, capsys, precision
):
    bundle_dir = _jax_bundle(tmp_path / "doc", _config(3, precision), fitted)
    args = _predict_args(history_csv, bundle_dir)
    want = _run(jax_main, args, capsys)
    got = _run(main, args + ["serve.device=cpu"], capsys)
    assert (want["documents"], want["records_per_document"], want["rows_dropped"]) == (
        11, 3, 2,
    )
    _assert_same(got, want, precision)


def test_a_port_bundle_loads_and_predicts_in_jax(tmp_path, history_csv, capsys):
    kw = _config(3, "f32")
    columns, _ = generate_synthetic(600, seed=0)
    prep = Preprocessor.fit(columns)
    model = init_params(build_doc_model(ModelConfig(**kw)), seed=4)
    save_doc_bundle(
        tmp_path / "port_doc", ModelConfig(**kw), model, prep,
        fit_monitor(prep.encode(columns)), calibration={"temperature": 0.8},
    )
    jax_bundle = jax_load_bundle(tmp_path / "port_doc")
    assert jax_bundle.flavor == "doc" and jax_bundle.temperature == 0.8
    port_bundle = load_bundle(tmp_path / "port_doc")
    for name, value in port_bundle.model.state_dict().items():
        assert torch.equal(value, model.state_dict()[name]), name
    args = _predict_args(history_csv, tmp_path / "port_doc")
    want = _run(jax_main, args, capsys)
    got = _run(main, args + ["serve.device=cpu"], capsys)
    _assert_same(got, want, "f32")


# --------------------------------------------------------------- refusals
def test_predict_file_needs_the_card_unless_asked_for_the_cpu(
    tmp_path, fitted, history_csv
):
    if torch.cuda.is_available():
        pytest.skip("this machine has a card: the refusal needs a card-less one")
    bundle_dir = _jax_bundle(tmp_path / "doc", _config(2, "f32"), fitted)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        main(_predict_args(history_csv, bundle_dir))
    with pytest.raises(RuntimeError, match="no CUDA device"):
        main(_predict_args(history_csv, bundle_dir) + ["serve.device=cuda"])


def test_predict_file_refuses_a_bundle_that_is_not_doc_flavor(tmp_path, history_csv):
    columns, _ = generate_synthetic(400, seed=0)
    prep = Preprocessor.fit(columns)
    save_quant_bundle(
        tmp_path / "quant", prep, fit_monitor(prep.encode(columns), drift_ref_size=128),
        quantize_student(init_quant_master(0)), gates={"passed": True},
    )
    with pytest.raises(SystemExit, match="exact tier.*no exact-tier params"):
        main(_predict_args(history_csv, tmp_path / "quant") + ["serve.device=cpu"])


def test_the_doc_model_refuses_what_is_not_on_its_path():
    with pytest.raises(ValueError, match="seq_parallel"):
        build_doc_model(ModelConfig(**_config(3, "f32"), seq_parallel=True))
    # The attend seam takes the ring (parallel/ring_attention.py): the
    # function given replaces the dense dispatcher.
    seen = []
    ring = MultiHeadSelfAttention(
        16, 2, torch.float32, attend_fn=lambda q, k, v: seen.append(q.shape) or v
    )
    ring(torch.zeros(1, 4, 16))
    assert seen == [(1, 4, 2, 8)]
    layer = MultiHeadSelfAttention(16, 2, torch.float32)
    with pytest.raises(ValueError, match="masks"):
        layer(torch.zeros(1, 4, 16), mask=torch.ones(1, 4, dtype=torch.bool))
