"""The port's local HF cache (meant_tpu_torch/utils/hf_cache.py) and HF
importers (meant_tpu_torch/utils/port.py) on the CPU against the JAX
package, on caches written here by `transformers` and `safetensors` (the
port reads the safetensors format itself):

* the hub layout with `refs/main`: a 3-shard safetensors with a BF16
  tensor, a single safetensors and a `pytorch_model.bin`, each read equal
  to JAX's `load_state_dict` (dtypes and bits); a missing cache raises
  FileNotFoundError in both packages;
* `import_hf_roberta`, `import_visual_bert` and `import_vilt` give JAX's
  trees bit for bit, and the port's models at those weights give the JAX
  models' outputs at 1e-5;
* the four `hf_graft` flows (bertweet's backbone, the meant family's
  embedding, ViLT and VisualBERT with bertweet's word table) give JAX's
  grafted entries bit for bit; a cache whose head count differs from the
  model's raises in both packages (Flax's shape check in JAX, a ValueError
  in the port, whose (d, d) projections would load silently); a BF16
  tensor grafts widened to fp32 exactly (JAX's `_t` raises a TypeError).

Sizes: width 32-48 in 4 heads, 2 layers, vocab <= 150, the bertweet cache
at 130 positions.
"""

import json
import os

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from flax.errors import ScopeParamShapeError

from meant_tpu.nn import hf_baselines as j_hf
from meant_tpu.nn import roberta as j_roberta
from meant_tpu.utils import hf_cache as j_cache
from meant_tpu.utils import port as j_port
from meant_tpu_torch.cli.common import base_parser, build_model
from meant_tpu_torch.nn import hf_baselines, roberta
from meant_tpu_torch.utils import hf_cache, port
from meant_tpu_torch.weights import state_dict_from_jax

import torch_threads

torch_threads.share_cores()

transformers = pytest.importorskip("transformers")
safetensors_torch = pytest.importorskip("safetensors.torch")

VOCAB, HIDDEN, LAYERS, HEADS, MAXPOS = 100, 32, 2, 4, 130
BERTWEET = "vinai/bertweet-base"


def _roberta_sd_and_cfg(seed=0, maxpos=MAXPOS, prefix=""):
    cfg = transformers.RobertaConfig(
        vocab_size=VOCAB, hidden_size=HIDDEN, num_hidden_layers=LAYERS,
        num_attention_heads=HEADS, intermediate_size=4 * HIDDEN,
        max_position_embeddings=maxpos, type_vocab_size=1, pad_token_id=1,
        hidden_dropout_prob=0.0, attention_probs_dropout_prob=0.0)
    torch.manual_seed(seed)
    model = transformers.RobertaModel(cfg).eval()
    return ({prefix + k: v for k, v in model.state_dict().items()},
            cfg.to_dict(), model)


def _write_hub_cache(root, repo_id, sd, config, fmt="safetensors",
                     shards=1):
    """A hub-layout cache: models--org--name/refs/main + snapshots/<rev>/
    {config.json, weights}, beside an older snapshot refs/main skips."""
    mdir = os.path.join(root, "models--" + repo_id.replace("/", "--"))
    for rev in ("0ld", "deadbeefcafe"):
        snap = os.path.join(mdir, "snapshots", rev)
        os.makedirs(snap, exist_ok=True)
        with open(os.path.join(snap, "config.json"), "w") as f:
            json.dump(config, f)
    os.makedirs(os.path.join(mdir, "refs"), exist_ok=True)
    with open(os.path.join(mdir, "refs", "main"), "w") as f:
        f.write(rev)
    sd = {k: v.contiguous() for k, v in sd.items()}
    if fmt == "bin":
        torch.save(sd, os.path.join(snap, "pytorch_model.bin"))
    elif shards == 1:
        safetensors_torch.save_file(sd, os.path.join(snap,
                                                     "model.safetensors"))
    else:
        keys = sorted(sd)
        per = (len(keys) + shards - 1) // shards
        weight_map = {}
        for i in range(shards):
            part = {k: sd[k] for k in keys[i * per:(i + 1) * per]}
            fname = f"model-{i + 1:05d}-of-{shards:05d}.safetensors"
            safetensors_torch.save_file(part, os.path.join(snap, fname))
            weight_map.update({k: fname for k in part})
        with open(os.path.join(snap, "model.safetensors.index.json"),
                  "w") as f:
            json.dump({"weight_map": weight_map}, f)
    return snap


@pytest.mark.parametrize("fmt,shards", [("safetensors", 3),
                                        ("safetensors", 1), ("bin", 1)])
def test_reader_matches_jax(tmp_path, fmt, shards):
    sd, cfg, _ = _roberta_sd_and_cfg(prefix="roberta.")
    sd["roberta.embeddings.word_embeddings.weight"] = \
        sd["roberta.embeddings.word_embeddings.weight"].to(torch.bfloat16)
    sd["roberta.pooler.dense.bias"] = sd["roberta.pooler.dense.bias"].half()
    _write_hub_cache(str(tmp_path), BERTWEET, sd, cfg, fmt, shards)
    want_cfg, want = j_cache.load_pretrained(BERTWEET, str(tmp_path))
    got_cfg, got = hf_cache.load_pretrained(BERTWEET, str(tmp_path))
    assert got_cfg == want_cfg and sorted(got) == sorted(want) == sorted(sd)
    for k, v in want.items():
        assert got[k].dtype == v.dtype == sd[k].dtype, k
        assert torch.equal(got[k], v), k


def test_missing_cache_raises_in_both(tmp_path):
    for module in (hf_cache, j_cache):
        with pytest.raises(FileNotFoundError, match="no local cache"):
            module.resolve_snapshot("nope/never-downloaded", str(tmp_path))


def _same_tree(got, want):
    assert sorted(got) == sorted(want)
    for k, v in want.items():
        if isinstance(v, dict):
            _same_tree(got[k], v)
        else:
            np.testing.assert_array_equal(got[k], v, err_msg=k)


def _roberta_case():
    sd, _, _ = _roberta_sd_and_cfg(1, maxpos=40, prefix="roberta.")
    rng = np.random.RandomState(0)
    ids = rng.randint(2, VOCAB, (2, 10)).astype(np.int32)
    mask = np.ones((2, 10), np.float32)
    ids[:, 7:], mask[:, 7:] = 1, 0
    geometry = dict(vocab_size=VOCAB, hidden_size=HIDDEN, num_layers=LAYERS,
                    num_heads=HEADS, intermediate_size=4 * HIDDEN,
                    max_position_embeddings=40, dropout=0.0)
    return (lambda m: m.import_hf_roberta(sd, LAYERS, num_heads=HEADS),
            j_roberta.RobertaModel(**geometry),
            roberta.RobertaModel(**geometry, device="cpu"),
            (ids, mask), {})


def _visual_bert_case():
    cfg = transformers.VisualBertConfig(
        vocab_size=120, hidden_size=48, num_hidden_layers=LAYERS,
        num_attention_heads=HEADS, intermediate_size=96,
        visual_embedding_dim=32, max_position_embeddings=64,
        type_vocab_size=2)
    torch.manual_seed(2)
    sd = transformers.VisualBertModel(cfg).state_dict()
    rng = np.random.RandomState(1)
    ids = rng.randint(0, 120, (2, 10)).astype(np.int32)
    kw = dict(attention_mask=np.zeros((2, 10), np.float32),
              token_type_ids=np.ones((2, 10), np.int32),
              visual_embeds=rng.randn(2, 6, 32).astype(np.float32))
    geometry = dict(vocab_size=120, hidden_size=48, num_layers=LAYERS,
                    num_heads=HEADS, intermediate_size=96,
                    visual_embedding_dim=32, max_position_embeddings=64,
                    dropout=0.0)
    return (lambda m: m.import_visual_bert(sd, LAYERS, num_heads=HEADS),
            j_hf.VisualBertModel(**geometry),
            hf_baselines.VisualBertModel(**geometry, device="cpu"),
            (ids,), kw)


def _vilt_case():
    cfg = transformers.ViltConfig(
        vocab_size=150, hidden_size=48, num_hidden_layers=LAYERS,
        num_attention_heads=HEADS, intermediate_size=96,
        max_position_embeddings=32, type_vocab_size=2,
        modality_type_vocab_size=2, image_size=64, patch_size=16,
        num_channels=3, max_image_length=-1)
    torch.manual_seed(3)
    sd = transformers.ViltModel(cfg).state_dict()
    rng = np.random.RandomState(2)
    ids = rng.randint(0, 150, (2, 8)).astype(np.int32)
    pixels = rng.randn(2, 3, 64, 64).astype(np.float32)
    kw = dict(attention_mask=np.zeros((2, 8), np.float32),
              token_type_ids=np.ones((2, 8), np.int32))
    geometry = dict(vocab_size=150, hidden_size=48, num_layers=LAYERS,
                    num_heads=HEADS, intermediate_size=96,
                    max_position_embeddings=32, image_size=64,
                    patch_size=16, dropout=0.0)
    return (lambda m: m.import_vilt(sd, LAYERS, num_heads=HEADS),
            j_hf.ViltModel(**geometry),
            hf_baselines.ViltModel(**geometry, device="cpu"),
            (ids, pixels), kw)


@pytest.mark.parametrize("case", [_roberta_case, _visual_bert_case,
                                  _vilt_case],
                         ids=["roberta", "visual_bert", "vilt"])
def test_importers_match_jax(case):
    """The port's tree is JAX's bit for bit, and the port's model at it
    gives the JAX model's hidden states and pooled output."""
    importer, jm, model, args, kw = case()
    tree = importer(port)
    _same_tree(tree, importer(j_port))
    want = jax.jit(lambda p: jm.apply({"params": p}, *args, **kw))(tree)
    model.load_state_dict(state_dict_from_jax(tree), strict=True)
    model.eval()
    with torch.no_grad():
        got = model(*map(torch.as_tensor, args),
                    **{k: torch.as_tensor(v) for k, v in kw.items()})
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-5,
                                   atol=1e-5)


@pytest.fixture(scope="module")
def caches(tmp_path_factory):
    """bertweet (3 shards), ViLT and VisualBERT (.bin) hub caches whose
    geometry the CLI's models take at width 32, 4 heads, 2 layers, vocab
    100 (ViLT's 384 / 32 grid, 4 channels; VisualBERT's 2048 visual
    features)."""
    root = str(tmp_path_factory.mktemp("hf"))
    sd, cfg, _ = _roberta_sd_and_cfg()
    _write_hub_cache(root, BERTWEET, sd, cfg, shards=3)
    common = dict(hidden_size=HIDDEN, num_hidden_layers=LAYERS,
                  num_attention_heads=HEADS, intermediate_size=4 * HIDDEN,
                  vocab_size=50, type_vocab_size=2)
    torch.manual_seed(4)
    vcfg = transformers.ViltConfig(
        max_position_embeddings=40, modality_type_vocab_size=2,
        image_size=384, patch_size=32, num_channels=4, max_image_length=-1,
        **common)
    _write_hub_cache(root, "dandelin/vilt-b32-mlm",
                     transformers.ViltModel(vcfg).state_dict(),
                     vcfg.to_dict(), fmt="bin")
    vbcfg = transformers.VisualBertConfig(
        visual_embedding_dim=2048, max_position_embeddings=512, **common)
    _write_hub_cache(root, "uclanlp/visualbert-vqa-coco-pre",
                     transformers.VisualBertModel(vbcfg).state_dict(),
                     vbcfg.to_dict(), fmt="bin")
    return root


def _args(name, heads=HEADS):
    return base_parser().parse_args([
        "-rid", "0", "-mn", name, "-nec", str(LAYERS), "--text_dim",
        str(HIDDEN), "--image_dim", str(HIDDEN), "--num_heads", str(heads),
        "--vocab_size", str(VOCAB), "--seq_len", "8", "--image_size", "32",
        "--bf16", "false", "--device", "cpu"])


# the JAX param subtree each flow replaces or fills
FLOW_ROOTS = {"bertweet": "bertweet", "meant_tweet": "embedding",
              "vilt": "vilt", "vl_bert": "model"}


@pytest.mark.parametrize("name", list(FLOW_ROOTS))
def test_hf_graft_flows_match_jax(caches, name):
    model = build_model(_args(name))
    target = model.state_dict()
    got = hf_cache.hf_graft(name, target, LAYERS, HEADS, cache_dir=caches)
    root = FLOW_ROOTS[name]
    grafted = j_cache.hf_graft(name, {root: {}}, LAYERS, cache_dir=caches)
    want = state_dict_from_jax({root: grafted[root]})
    if name == "bertweet":
        assert set(got) == {k for k in target if k.startswith("bertweet.")}
    assert sorted(got) == sorted(want)
    for k, v in want.items():
        assert torch.equal(got[k], v), k
    model.load_state_dict({**target, **got})
    words = hf_cache.load_pretrained(BERTWEET, caches)[1][
        "embeddings.word_embeddings.weight"]
    table = {"bertweet": "bertweet.embeddings.word_embeddings.weight",
             "meant_tweet": "embedding.word_embeddings.weight",
             "vilt": "vilt.text_embeddings.word_embeddings.weight",
             "vl_bert": "model.text_embeddings.word_embeddings.weight"}[name]
    assert torch.equal(model.state_dict()[table], words)


def test_head_count_other_than_the_caches_raises_in_both(caches):
    """A 4-head bertweet cache into a 2-head model: JAX's importer splits
    the projections into 4 heads and Flax refuses the tree; the port's
    (d, d) matrices would load, so hf_graft compares the counts."""
    jm = j_roberta.bertweet_wrapper(input_dim=HIDDEN, output_dim=2,
                                    vocab_size=VOCAB, num_layers=LAYERS,
                                    num_heads=2)
    params = j_cache.hf_graft("bertweet", {}, LAYERS, cache_dir=caches)
    params["head_norm"] = {"scale": np.ones(HIDDEN, np.float32),
                           "bias": np.zeros(HIDDEN, np.float32)}
    params["head"] = {"kernel": np.zeros((HIDDEN, 2), np.float32),
                      "bias": np.zeros(2, np.float32)}
    with pytest.raises(ScopeParamShapeError):
        jm.apply({"params": params}, np.full((1, 8), 5, np.int32))
    model = build_model(_args("bertweet", heads=2))
    with pytest.raises(ValueError, match="4 attention heads, the model 2"):
        hf_cache.hf_graft("bertweet", model.state_dict(), LAYERS, 2,
                          cache_dir=caches)


def test_bf16_tensor_grafts_widened_exactly(tmp_path):
    sd, cfg, _ = _roberta_sd_and_cfg(5)
    key = "embeddings.word_embeddings.weight"
    sd[key] = sd[key].to(torch.bfloat16)
    _write_hub_cache(str(tmp_path), BERTWEET, sd, cfg, shards=3)
    target = build_model(_args("meant_tweet")).state_dict()
    got = hf_cache.hf_graft("meant_tweet", target, LAYERS, HEADS,
                            cache_dir=str(tmp_path))
    table = got["embedding.word_embeddings.weight"]
    assert table.dtype == torch.float32
    assert torch.equal(table, sd[key].to(torch.float32))
    with pytest.raises(TypeError):     # numpy has no bf16
        j_cache.hf_graft("meant_tweet", {"embedding": {}}, LAYERS,
                         cache_dir=str(tmp_path))
