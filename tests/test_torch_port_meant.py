"""The MEANT-family importers and `export_meant` of the port
(meant_tpu_torch/utils/port.py) against the JAX package's
(meant_tpu/utils/port.py), on the CPU.

* Every importer gets the same state dict as its JAX counterpart, written
  here in the reference's key layout (as tests/test_port.py writes one),
  and returns an equal tree, leaf for leaf: the helpers (`linear_params`,
  `norm_params`, `attention_params` with and without the q/v/k swap,
  `encoder_params` at both final-Linear indices, `lm_head_params`), the
  model importers and `import_audio_encoder`.
* A narrow `meant` and `meant_src` (dim 32, 4 heads, one encoder a tower),
  their JAX params written out in the reference's layout and read back
  through the port's importer, give JAX's probabilities at 1e-4.
* `export_meant` of the port's own `meant` state dict equals JAX's
  `export_meant` of the params `load_jax_params` carried over, key for
  key and value for value; importing the export gives the state dict back
  exactly.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from meant_tpu.models import EmbeddingConfig as JEmb
from meant_tpu.models import meant as j_meant
from meant_tpu.models.meant_src import meant_src as j_meant_src
from meant_tpu.utils import port as jport
from meant_tpu_torch import models
from meant_tpu_torch.utils import port as tport
from meant_tpu_torch.weights import load_jax_params, state_dict_from_jax

import torch_threads

torch_threads.share_cores()

D, LAG = 16, 3


class RefSD(dict):
    """A state dict in the reference's key layout, seeded numpy values."""

    def __init__(self, seed):
        super().__init__()
        self.rng = np.random.RandomState(seed)

    def a(self, key, *shape):
        self[key] = self.rng.randn(*shape).astype(np.float32)

    def lin(self, p, i=D, o=D, bias=True):
        self.a(f"{p}.weight", o, i)
        if bias:
            self.a(f"{p}.bias", o)

    def norm(self, p, kind, d=D, offset=False):
        if kind == "rms":
            self.a(f"{p}.scale", d)
            if offset:
                self.a(f"{p}.offset", d)
        else:
            self.a(f"{p}.weight", d)
            self.a(f"{p}.bias", d)

    def emb(self, p="embedding.0."):
        self.a(f"{p}word_embeddings.weight", 20, D)
        self.a(f"{p}position_embeddings.weight", 12, D)
        self.a(f"{p}token_type_embeddings.weight", 1, D)
        self.a(f"{p}LayerNorm.weight", D)
        self.a(f"{p}LayerNorm.bias", D)

    def attention(self, p):
        for proj in ("q", "k", "v", "multi_mad"):
            self.lin(f"{p}.{proj}")

    def encoder(self, p, norm, ff_norm2=None, final=5, rotary=()):
        for blk in ("encode", "encode2"):
            self.norm(f"{p}.{blk}.0", norm)
            self.lin(f"{p}.{blk}.1")
            self.norm(f"{p}.{blk}.3", ff_norm2 if blk == "encode2" and
                      ff_norm2 else norm)
            self.lin(f"{p}.{blk}.{final}")
        self.attention(f"{p}.encode.2")
        freqs = self.rng.rand(4).astype(np.float32)
        for name in rotary:
            self[f"{p}.{name}.freqs"] = freqs

    def towers(self, n, norm, ff_norm2=None, language=("xPos",),
               vision=("posEmbed",)):
        for i in range(n):
            if language is not None:
                self.encoder(f"languageEncoders.{i}", norm, ff_norm2, 5,
                             language)
            if vision is not None:
                self.encoder(f"visionEncoders.{i}", norm, ff_norm2, 4,
                             vision)

    def temporal(self, p, norm, proj_out=4, temp_embedding=False):
        if temp_embedding:
            self.a(f"{p}.temp_embedding", 1, LAG, D)
        self.norm(f"{p}.temp_encode.0", norm)
        self.lin(f"{p}.temp_encode.1")
        self.attention(f"{p}.temp_encode.2")
        self.norm(f"{p}.temp_encode.3", norm)
        self.lin(f"{p}.temp_encode.{proj_out}")

    def slim(self, p="temporal_encoding.0"):
        self.a(f"{p}.temp_embedding", 1, LAG, D)
        self.lin(f"{p}.temp_encode.0")
        self.attention(f"{p}.temp_encode.1")
        self.lin(f"{p}.temp_encode.2")

    def head(self, kind):
        self.norm("mlpHead.0", kind)
        self.lin("mlpHead.1", D, 2)

    def timesformer(self, p, depth):
        self.lin(f"{p}to_patch_embedding", 12, D)
        self.a(f"{p}cls_token", 1, D)
        for i in range(depth):
            for slot in (0, 1):
                base = f"{p}layers.{i}.{slot}"
                self.norm(f"{base}.norm", "layer")
                self.lin(f"{base}.fn.to_qkv", D, 3 * D, bias=False)
                self.lin(f"{base}.fn.to_out.0")
            base = f"{p}layers.{i}.2"
            self.norm(f"{base}.norm", "layer")
            self.lin(f"{base}.fn.net.0", D, 2 * D)
            self.lin(f"{base}.fn.net.3", 2 * D, D)
        self.norm(f"{p}to_out.0", "layer")
        self.lin(f"{p}to_out.1", D, 5)


def _sd_meant(sd):
    sd.emb()
    sd.lin("patchEmbed.1", 48, D)
    sd.temporal("temporal_encoding.0", "rms", temp_embedding=True)
    sd.head("rms")
    sd.towers(2, "rms", language=("xPos", "encode.2.xPos"),
              vision=("posEmbed", "encode.2.pos_emb"))
    return (2,)


def _sd_meant_vision(sd):
    sd.lin("patchEmbed.1", 48, D)
    sd.slim()
    sd.head("layer")
    sd.towers(2, "rms", language=None)
    return (2,)


def _sd_language_pretrainer(sd, tie):
    sd.emb()
    sd.lin("mlm_head.dense")
    sd.norm("mlm_head.layer_norm", "layer")
    sd.lin("mlm_head.decoder", D, 20, bias=True)
    sd.towers(2, "rms", language=("encode.2.xPos",), vision=None)
    return (2, tie)


def _sd_vision_pretrainer(sd):
    sd.lin("patchEmbed.1", 48, D)
    sd.a("decoder.0.weight", 48, D, 1, 1)
    sd.a("decoder.0.bias", 48)
    sd.towers(1, "rms", language=None, vision=("encode.2.pos_emb",))
    return (1,)


def _sd_tweet_no_lag(sd):
    sd.emb()
    sd.a("txt_classtkn", D)
    sd.head("layer")
    sd.towers(2, "layer", vision=None)
    return (2,)


def _sd_meant_src(sd):
    sd.emb()
    sd.lin("patchEmbed.1", 48, D)
    for name in ("lang_proj", "image_proj"):
        sd.lin(f"{name}.0", D, 1)
        sd.norm(f"{name}.1", "layer", 1)
    sd.temporal("temporal_encoding.0", "layer")
    sd.head("layer")
    sd.towers(2, "layer", "rms")
    return (2,)


def _sd_meant_vqa(sd):
    sd.emb()
    sd.lin("patchEmbed.1", 48, D)
    sd.head("rms")
    sd.towers(2, "rms")
    return (2,)


def _sd_timesformer(sd):
    sd.timesformer("", 2)
    return (2,)


def _sd_meant_timesformer(sd):
    sd.emb()
    sd.timesformer("timesformer.", 1)
    for name in ("lang_prep", "image_prep"):
        sd.lin(f"{name}.0")
        sd.norm(f"{name}.1", "layer")
        sd.lin(f"{name}.3", D, 1)
    sd.temporal("temporal_encoding.0", "layer")
    sd.head("layer")
    sd.towers(2, "layer", "rms", vision=None)
    return (2, 1)


def _sd_mean_pooling(sd):
    sd.emb()
    sd.timesformer("timesformer.", 2)
    sd.lin("image_proj.0", D, 1)
    sd.norm("image_proj.1", "layer", 1)
    sd.temporal("temporal_encoding.0", "layer")
    sd.head("layer")
    sd.towers(1, "layer", "rms", vision=None)
    return (1, 2)


def _sd_tweet_price(sd):
    sd.emb()
    sd.temporal("temporal_encoding.0", "rms", proj_out=5,
                temp_embedding=True)
    sd.head("layer")
    sd.towers(2, "rms", vision=None)
    return (2,)


def _sd_tweet(sd):
    sd.emb()
    sd.slim()
    sd.head("layer")
    sd.towers(2, "rms", vision=None)
    return (2,)


def _sd_price(sd):
    sd.lin("temporal_encoding.0.temp_encode.0")
    sd.attention("temporal_encoding.0.temp_encode.1")
    sd.lin("temporal_encoding.0.temp_encode.2")
    sd.head("layer")
    return ()


def _sd_temporal2(sd):
    for proj in ("q", "k", "v", "multi_mad.0"):
        sd.lin(f"lag.{proj}")
    return ("lag.",)


def _sd_mlp(sd, lstm=False):
    sd.lin("input_layer.0", 5, D)
    sd.norm("input_layer.1", "layer")
    sd.lin("output_layer.0", D, 2)
    for i in range(3):
        if lstm:
            sd.a(f"hidden.weight_ih_l{i}", 4 * D, D)
            sd.a(f"hidden.weight_hh_l{i}", 4 * D, D)
            sd.a(f"hidden.bias_ih_l{i}", 4 * D)
            sd.a(f"hidden.bias_hh_l{i}", 4 * D)
        else:
            sd.lin(f"hidden.{i}.0")
            sd.norm(f"hidden.{i}.1", "layer")
    return (3,)


def _sd_audio(sd):
    sd.a("audio_emb.weight", 1, D)
    for i in range(2):
        p = f"audio_encoder.layers.{i}."
        sd.a(f"{p}self_attn.in_proj_weight", 3 * D, D)
        sd.a(f"{p}self_attn.in_proj_bias", 3 * D)
        sd.lin(f"{p}self_attn.out_proj")
        sd.lin(f"{p}linear1", D, 2 * D)
        sd.lin(f"{p}linear2", 2 * D, D)
        sd.norm(f"{p}norm1", "layer")
        sd.norm(f"{p}norm2", "layer")
    return (2, 4)


def _sd_helpers(sd, which):
    sd.lin("a", bias=False)
    sd.lin("b")
    sd.norm("n_rms", "rms", offset=True)
    sd.norm("n_rms1", "rms")
    sd.norm("n_layer", "layer")
    sd.attention("att")
    sd["att_freqs"] = np.arange(4, dtype=np.float32)
    sd.encoder("enc5", "layer", "rms", 5, ("rot",))
    sd.encoder("enc4", "rms", None, 4, ())
    sd.lin("lm_head.dense")
    sd.norm("lm_head.layer_norm", "layer")
    sd.lin("lm_head.decoder", D, 20)
    return which


HELPERS = {
    "linear_params": lambda m: [m.linear_params(_SD_H, "a"),
                                m.linear_params(_SD_H, "b")],
    "norm_params": lambda m: [m.norm_params(_SD_H, "n_rms", "rms"),
                              m.norm_params(_SD_H, "n_rms1", "rms"),
                              m.norm_params(_SD_H, "n_layer", "layer")],
    "attention_params": lambda m: [
        m.attention_params(_SD_H, "att", swap_kv=True, freqs_key="att_freqs"),
        m.attention_params(_SD_H, "att", swap_kv=False)],
    "encoder_params": lambda m: [
        m.encoder_params(_SD_H, "enc5", norm="layer", ff_norm2="rms",
                         xpos_prefix="enc5.rot"),
        m.encoder_params(_SD_H, "enc4", norm="rms")],
    "lm_head_params": lambda m: [m.lm_head_params(_SD_H, "lm_head.")],
}
_SD_H = RefSD(99)
_sd_helpers(_SD_H, None)

# importer name -> writer of its state dict (returns the importer's extra
# positional arguments)
IMPORTERS = {
    "import_meant": _sd_meant,
    "import_meant_vision": _sd_meant_vision,
    "import_language_pretrainer": lambda sd: _sd_language_pretrainer(sd,
                                                                     True),
    "import_language_pretrainer_untied": lambda sd: _sd_language_pretrainer(
        sd, False),
    "import_vision_pretrainer": _sd_vision_pretrainer,
    "import_meant_tweet_no_lag": _sd_tweet_no_lag,
    "import_meant_src": _sd_meant_src,
    "import_meant_vqa": _sd_meant_vqa,
    "import_timesformer": _sd_timesformer,
    "import_meant_timesformer": _sd_meant_timesformer,
    "import_meant_mean_pooling": _sd_mean_pooling,
    "import_meant_tweet_price": _sd_tweet_price,
    "import_meant_tweet": _sd_tweet,
    "import_meant_price": _sd_price,
    "import_temporal2": _sd_temporal2,
    "import_mlp_encoder": _sd_mlp,
    "import_lstm_encoder": lambda sd: _sd_mlp(sd, lstm=True),
    "import_audio_encoder": _sd_audio,
}


def _assert_same_tree(got, want, path=""):
    if isinstance(want, dict):
        assert isinstance(got, dict) and set(got) == set(want), (
            path, sorted(set(got) ^ set(want)))
        for k in want:
            _assert_same_tree(got[k], want[k], f"{path}/{k}")
    elif isinstance(want, (list, tuple)):
        assert len(got) == len(want), path
        for i, (g, w) in enumerate(zip(got, want)):
            _assert_same_tree(g, w, f"{path}[{i}]")
    else:
        g, w = np.asarray(got), np.asarray(want)
        assert g.dtype == w.dtype and g.shape == w.shape, (path, g.shape,
                                                           w.shape)
        np.testing.assert_array_equal(g, w, err_msg=path)


@pytest.mark.parametrize("name", sorted(HELPERS))
def test_helper_matches_jax(name):
    _assert_same_tree(HELPERS[name](tport), HELPERS[name](jport))


@pytest.mark.parametrize("name", sorted(IMPORTERS))
def test_importer_matches_jax_leaf_for_leaf(name):
    sd = RefSD(len(name))
    args = IMPORTERS[name](sd)
    fn = name.replace("_untied", "")
    got = getattr(tport, fn)(sd, *args)
    want = getattr(jport, fn)(sd, *args)
    _assert_same_tree(got, want)
    # torch tensors in the state dict give the same tree
    _assert_same_tree(getattr(tport, fn)(
        {k: torch.as_tensor(v) for k, v in sd.items()}, *args), want)


# ---- narrow models through the importer -----------------------------------

EMB = dict(vocab_size=50, hidden_size=32, max_position_embeddings=20,
           dropout=0.0)
GEOM = dict(text_dim=32, image_dim=32, lag=5, num_classes=2, num_heads=4,
            num_encoders=1, height=32, width=32, patch_res=16)
B, S = 2, 12


def _batch(seed, src):
    rng = np.random.RandomState(seed)
    ids = rng.randint(2, 50, (B, 5, S)).astype(np.int32)
    ids[0, 1, 8:] = 1
    mask = (ids != 1).astype(np.float32)
    if src:
        return {"input_ids": ids,
                "pixels": rng.randn(B, 5, 3, 32, 32).astype(np.float32),
                "prices": rng.randn(B, 5, 5).astype(np.float32),
                "attention_mask": mask}
    return {"tweets": ids,
            "graphs": rng.randn(B, 5, 4, 32, 32).astype(np.float32),
            "attention_mask": mask}


def _jax_model(src):
    if src:
        return j_meant_src(embedding=JEmb(**EMB), price_dim=5, channels=3,
                           seq_len=S, **GEOM)
    return j_meant(embedding=JEmb(**EMB), price_dim=4, channels=4, **GEOM)


def _port_model(src):
    emb = models.EmbeddingConfig(**EMB)
    if src:
        return models.meant_src(embedding=emb, price_dim=5, channels=3,
                                seq_len=S, device="cpu", **GEOM)
    return models.meant(embedding=emb, price_dim=4, channels=4, device="cpu",
                        **GEOM)


def _reference_meant_src(p, n):
    """JAX meant_src params in the src-era reference's layout
    (`src/meant/meant.py`), written with the JAX package's inverse
    helpers."""
    out = {}
    emb = p["embedding"]
    for name in ("word_embeddings", "position_embeddings",
                 "token_type_embeddings"):
        out[f"embedding.0.{name}.weight"] = np.asarray(emb[name])
    out["embedding.0.LayerNorm.weight"] = np.asarray(emb["ln_scale"])
    out["embedding.0.LayerNorm.bias"] = np.asarray(emb["ln_bias"])
    jport._unlinear(p["patchEmbed"], out, "patchEmbed.1")
    for name in ("lang_proj", "image_proj"):
        jport._unlinear(p[name]["proj"], out, f"{name}.0")
        jport._unnorm(p[name]["norm"], out, f"{name}.1", "layer")
    t, e = p["temporal_encoding_0"], "temporal_encoding.0.temp_encode"
    jport._unnorm(t["norm1"], out, f"{e}.0", "layer")
    jport._unlinear(t["proj_in"], out, f"{e}.1")
    jport._unattention(t["temporal"], out, f"{e}.2", swap_kv=False)
    jport._unnorm(t["norm2"], out, f"{e}.3", "layer")
    jport._unlinear(t["proj_out"], out, f"{e}.4")
    jport._unnorm(p["mlpHead"]["norm"], out, "mlpHead.0", "layer")
    jport._unlinear(p["mlpHead"]["proj"], out, "mlpHead.1")
    for i in range(n):
        jport._unencoder(p[f"languageEncoders_{i}"], out,
                         f"languageEncoders.{i}", norm="layer",
                         ff_norm2="rms", dropout_in_encode=True,
                         xpos_prefix=f"languageEncoders.{i}.xPos")
        jport._unencoder(p[f"visionEncoders_{i}"], out,
                         f"visionEncoders.{i}", norm="layer", ff_norm2="rms",
                         dropout_in_encode=False,
                         xpos_prefix=f"visionEncoders.{i}.posEmbed")
    return out


def _jax_params(src, seed):
    """The JAX model's param tree (its shapes from `jax.eval_shape` of its
    init, which runs nothing) filled with seeded numpy values."""
    jb = {k: jnp.asarray(v) for k, v in _batch(0, src).items()}
    model = _jax_model(src)
    shapes = jax.eval_shape(
        lambda: model.init(jax.random.PRNGKey(0), **jb) if src
        else model.init(jax.random.PRNGKey(0), jb["tweets"], jb["graphs"]))
    rng = np.random.RandomState(seed)
    return jax.tree.map(
        lambda t: (rng.randn(*t.shape) * 0.2).astype(np.float32),
        shapes["params"])


@pytest.fixture(scope="module")
def meant_params():
    return _jax_params(False, 3)


@pytest.mark.parametrize("src", [False, True], ids=["meant", "meant_src"])
def test_narrow_model_through_the_importer_gives_jax_probabilities(
        src, meant_params):
    batch = _batch(1, src)
    jb = {k: jnp.asarray(v) for k, v in batch.items()}
    model = _jax_model(src)
    if src:
        params = _jax_params(True, 4)
        sd = _reference_meant_src(params, 1)
        tree = tport.import_meant_src(sd, 1)
        want = jax.jit(lambda p: model.apply({"params": p}, **jb))(params)
    else:
        params = meant_params
        sd = jport.export_meant(params, 1)
        tree = tport.import_meant(sd, 1)
        want = jax.jit(lambda p: model.apply(
            {"params": p}, jb["tweets"], jb["graphs"],
            attention_mask=jb["attention_mask"]))(params)
    port_model = _port_model(src).eval()
    load_jax_params(port_model, tree)
    tb = {k: torch.as_tensor(v) for k, v in batch.items()}
    with torch.no_grad():
        got = (port_model(**tb) if src else
               port_model(tb["tweets"], tb["graphs"],
                          attention_mask=tb["attention_mask"]))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-4,
                               atol=1e-4)


def test_export_meant_matches_jax_and_round_trips(meant_params):
    model = _port_model(False)
    load_jax_params(model, meant_params)
    own = model.state_dict()
    got = tport.export_meant(own, 1)
    want = jport.export_meant(meant_params, 1)
    assert set(got) == set(want)
    for key in want:
        assert got[key].dtype == want[key].dtype, key
        np.testing.assert_array_equal(got[key], want[key], err_msg=key)
    back = state_dict_from_jax(tport.import_meant(got, 1))
    assert set(back) == set(own)
    for key, value in own.items():
        assert torch.equal(back[key], value), key
