"""The port's HF import and export (whisperseg_torch/models/convert_hf.py,
export_hf.py) against the JAX package's, and the text helpers of its
tokenizer and codec.

Test model: 2+2 layers, d_model 128, 2 heads of 64 (the port's attention
needs a head width of 64 or 128), 100 spectrogram columns, float32."""

import filecmp
import json
import os

import jax
import numpy as np
import pytest
import torch
from safetensors.numpy import load_file

from whisperseg_tpu import codec as jcodec
from whisperseg_tpu import tokenizer as jtok
from whisperseg_tpu.models import convert_hf as jconv
from whisperseg_tpu.models import export_hf as jexp
from whisperseg_tpu.models import whisper as jw
from whisperseg_tpu.models.config import WhisperConfig as JaxConfig
from whisperseg_torch import codec, tokenizer
from whisperseg_torch.checkpoint import load_checkpoint
from whisperseg_torch.models import convert_hf, export_hf
from whisperseg_torch.models import whisper as tw
from whisperseg_torch.models.config import WhisperConfig
from whisperseg_torch.segmenter import Segmenter
from whisperseg_torch.synthetic import tone_bursts

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TINY = os.path.join(ROOT, "pretrained", "whisperseg-tiny-animal-vad")
GOLDEN = os.path.join(ROOT, "whisperseg_torch", "golden_tiny.json")
FILES = ("config.json", "vocab.json", "merges.txt", "added_tokens.json",
         "special_tokens_map.json", "tokenizer_config.json")


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """The port on one torch thread: beside the other test processes its
    threads would contend for the same cores (the results do not depend
    on it)."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _cfg_kwargs(**kw):
    base = dict(d_model=128, encoder_layers=2, decoder_layers=2, num_heads=2,
                d_ff=256, max_source_positions=50, max_target_positions=64,
                total_spec_columns=100, compute_dtype="float32",
                cluster_codebook={"Vocal": 0, "Chirp": 1},
                default_segmentation_config={"sr": 16000, "spec_time_step": 0.01,
                                             "min_frequency": 0, "max_length": 32},
                current_step=123)
    base.update(kw)
    return base


CASES = {
    "mha_frame_head": dict(frame_head=True, frame_head_clusters=2),
    "gqa_extra_tokens": dict(
        num_heads=4, d_model=256, d_ff=512, num_kv_heads=2,
        cluster_codebook={"a": 11, "b": 123}, extra_tokens=["12", "23"],
        cluster_encodings={"11": ["1", "1"], "123": ["1", "23"]},
        vocab_size=tokenizer.VOCAB_SIZE + 128),
}


def _models(case, seed=0):
    """The same float32 numpy parameters as a JAX tree and a port tree."""
    kw = _cfg_kwargs(**CASES[case])
    jcfg, cfg = JaxConfig(**kw), WhisperConfig(**kw)
    jparams = jax.tree.map(lambda x: np.array(x, np.float32),
                           jw.init_params(jax.random.PRNGKey(seed), jcfg))
    params = jax.tree.map(lambda x: torch.from_numpy(x.copy()), jparams)
    return jparams, jcfg, params, cfg


def _flat(tree, prefix=""):
    for k, v in tree.items():
        name = f"{prefix}.{k}" if prefix else k
        if isinstance(v, dict):
            yield from _flat(v, name)
        else:
            yield name, np.asarray(v)


def _same_leaves(a, b, skip=()):
    fa, fb = dict(_flat(a)), dict(_flat(b))
    assert fa.keys() == fb.keys()
    for k in fa:
        if k not in skip:
            assert fa[k].dtype == fb[k].dtype == np.float32, k
            np.testing.assert_array_equal(fa[k], fb[k], err_msg=k)


def _cfg_dict(cfg):
    return json.loads(json.dumps({k: v for k, v in cfg.__dict__.items()}))


@pytest.mark.parametrize("case", sorted(CASES))
def test_export_files_equal_jax_export(case, tmp_path):
    jparams, jcfg, params, cfg = _models(case)
    ours = export_hf.export_hf_checkpoint(params, cfg, str(tmp_path / "port"))
    theirs = jexp.export_hf_checkpoint(jparams, jcfg, str(tmp_path / "jax"))
    a = load_file(os.path.join(ours, "model.safetensors"))
    b = load_file(os.path.join(theirs, "model.safetensors"))
    assert a.keys() == b.keys()
    for k in a:
        assert a[k].dtype == b[k].dtype and a[k].shape == b[k].shape, k
        np.testing.assert_array_equal(a[k], b[k], err_msg=k)
    for name in FILES:
        assert filecmp.cmp(os.path.join(ours, name), os.path.join(theirs, name),
                           shallow=False), name


@pytest.mark.parametrize("case", sorted(CASES))
def test_imports_either_way_give_identical_leaves(case, tmp_path):
    jparams, jcfg, params, cfg = _models(case, seed=1)
    port_dir = export_hf.export_hf_checkpoint(params, cfg, str(tmp_path / "p"))
    jax_dir = jexp.export_hf_checkpoint(jparams, jcfg, str(tmp_path / "j"))
    # the port imports JAX's export, JAX imports the port's
    p2, c2 = convert_hf.import_hf_checkpoint(jax_dir, total_spec_columns=None)
    j2, jc2 = jconv.import_hf_checkpoint(port_dir, total_spec_columns=None)
    j2 = jax.tree.map(np.asarray, j2)
    _same_leaves(jax.tree.map(lambda t: t.numpy(), p2), j2)
    assert _cfg_dict(c2) == _cfg_dict(jc2)
    assert c2.extra_tokens == cfg.extra_tokens
    assert c2.cluster_encodings == cfg.cluster_encodings
    assert c2.vocab_size == cfg.vocab_size
    assert c2.frame_head == cfg.frame_head
    if cfg.kv_heads == cfg.num_heads:  # MHA round-trips leaf for leaf
        _same_leaves(jax.tree.map(lambda t: t.numpy(), p2), jparams)


def test_merges_for_encodings_raise_where_jax_raises():
    ok = {"123": ["12", "3"], "12": ["12"]}
    assert export_hf._merges_for_encodings(ok) == jexp._merges_for_encodings(ok)
    assert export_hf._merges_for_encodings(ok) == ["1 2"]
    bad = {"12": ["1", "2"], "124": ["12", "4"]}
    with pytest.raises(ValueError, match="cannot reproduce"):
        jexp._merges_for_encodings(bad)
    with pytest.raises(ValueError, match="cannot reproduce"):
        export_hf._merges_for_encodings(bad)
    ranks = {("1", "2"): 0, ("2", "3"): 1}
    for s in ("123", "1223", "9", "2323"):
        assert (convert_hf.bpe_encode_digits(s, ranks)
                == jconv.bpe_encode_digits(s, ranks))


def _feats_ids(cfg, b=2, l=12):
    r = np.random.RandomState(0)
    feats = r.randn(b, cfg.num_mel_bins, cfg.total_spec_columns).astype(
        np.float32)
    ids = r.randint(0, tokenizer.VOCAB_SIZE, size=(b, l)).astype(np.int64)
    ids[:, :3] = tokenizer.PROMPT_IDS
    return torch.from_numpy(feats), torch.from_numpy(ids)


@pytest.mark.parametrize("case", sorted(CASES))
def test_transformers_loads_the_port_export(case, tmp_path):
    """transformers' logits on the port's export are within 2e-4 of the
    port's decoder; a GQA model comes out as the identical MHA."""
    transformers = pytest.importorskip("transformers")
    _, _, params, cfg = _models(case, seed=2)
    out = export_hf.export_hf_checkpoint(params, cfg, str(tmp_path / "hf"))
    hf = transformers.WhisperForConditionalGeneration.from_pretrained(out).eval()
    assert hf.config.total_spec_columns == cfg.total_spec_columns
    assert hf.config.cluster_codebook == cfg.cluster_codebook
    feats, ids = _feats_ids(cfg)
    with torch.no_grad():
        enc = tw.encoder_forward(params, cfg, feats)
        ours = tw.decoder_forward_train(params, cfg, enc, ids).numpy()
        theirs = hf(input_features=feats, decoder_input_ids=ids).logits.numpy()
    np.testing.assert_allclose(theirs, ours, atol=2e-4, rtol=2e-4)
    if cfg.kv_heads < cfg.num_heads:
        p2, c2 = convert_hf.import_hf_checkpoint(out, total_spec_columns=None)
        assert c2.kv_heads == c2.num_heads == cfg.num_heads
        with torch.no_grad():
            enc2 = tw.encoder_forward(p2, c2, feats)
            mha = tw.decoder_forward_train(p2, c2, enc2, ids).numpy()
        np.testing.assert_allclose(mha, ours, atol=2e-5, rtol=2e-5)


def _third_party_dir(path, transformers):
    """A directory as a third party writes it: ``save_pretrained`` of a
    random HF Whisper, with a GPT2-style vocab whose ids differ from ours,
    merges that make '12' one piece, and a cluster codebook in its config."""
    hf_cfg = transformers.WhisperConfig(
        d_model=128, encoder_layers=2, decoder_layers=2,
        encoder_attention_heads=2, decoder_attention_heads=2,
        encoder_ffn_dim=256, decoder_ffn_dim=256, num_mel_bins=80,
        max_source_positions=64, max_target_positions=64, vocab_size=1400,
        pad_token_id=50, bos_token_id=50, eos_token_id=50,
        decoder_start_token_id=400)
    torch.manual_seed(0)
    transformers.WhisperForConditionalGeneration(hf_cfg).save_pretrained(path)
    vocab = {str(d): 100 + d for d in range(10)}
    vocab["12"] = 300
    vocab["<|endoftext|>"] = 50
    added = {t: 400 + i for i, t in enumerate(jtok.ID_TO_TOKEN[12:])}
    with open(os.path.join(path, "vocab.json"), "w") as f:
        json.dump(vocab, f)
    with open(os.path.join(path, "added_tokens.json"), "w") as f:
        json.dump(added, f)
    with open(os.path.join(path, "merges.txt"), "w") as f:
        f.write("#version: 0.2\n1 2\n")
    with open(os.path.join(path, "config.json")) as f:
        raw = json.load(f)
    raw["cluster_codebook"] = {"a": 3, "b": 12, "c": 123}
    raw["total_spec_columns"] = 200
    with open(os.path.join(path, "config.json"), "w") as f:
        json.dump(raw, f)


def test_third_party_checkpoint_imports_as_jax_does(tmp_path):
    transformers = pytest.importorskip("transformers")
    path = str(tmp_path / "third")
    _third_party_dir(path, transformers)
    p, c = convert_hf.import_hf_checkpoint(path, total_spec_columns=None)
    jp, jc = jconv.import_hf_checkpoint(path, total_spec_columns=None)
    jp = jax.tree.map(np.asarray, jp)
    assert _cfg_dict(c) == _cfg_dict(jc)
    assert c.extra_tokens == ["12"] and c.cluster_encodings == {
        "12": ["12"], "123": ["12", "3"]}
    assert c.max_source_positions == 100  # cut from HF's 64 rows, extended
    pn = jax.tree.map(lambda t: t.numpy(), p)
    _same_leaves(pn, jp, skip=("decoder.tok_emb",))
    # the rows HF supplies are JAX's; the rest are random draws of their own
    token_map = jconv.build_token_map(path, c.extra_tokens)
    # every compact id (pad through eot) and the extended '12' are mapped;
    # the last added ids lie past HF's 1400 rows
    assert sorted(token_map) == list(range(tokenizer.VOCAB_SIZE + 1))
    rows = sorted(o for o, h in token_map.items() if h < 1400)
    assert len(rows) == tokenizer.VOCAB_SIZE + 1 - 12
    np.testing.assert_array_equal(pn["decoder"]["tok_emb"][rows],
                                  jp["decoder"]["tok_emb"][rows])
    assert pn["decoder"]["tok_emb"].shape == jp["decoder"]["tok_emb"].shape
    assert pn["decoder"]["tok_emb"].dtype == np.float32


def test_from_pretrained_on_an_hf_export_gives_jax_table(tmp_path):
    """The tiny checkpoint exported to HF at float32: the port imports it
    leaf for leaf as JAX does, and its table and token ids are JAX's (the
    golden record, which test_torch_segmenter holds to the JAX package)."""
    params, cfg = load_checkpoint(TINY)
    cfg.compute_dtype = "float32"
    out = export_hf.export_hf_checkpoint(params, cfg, str(tmp_path / "hf"))
    jp, _ = jconv.import_hf_checkpoint(out, total_spec_columns=None)
    seg = Segmenter.from_pretrained(out, inference_dtype="float32",
                                    device="cpu")
    _same_leaves(jax.tree.map(lambda t: t.numpy(), seg.params),
                 jax.tree.map(np.asarray, jp))
    _same_leaves(jax.tree.map(lambda t: t.numpy(), seg.params),
                 jax.tree.map(lambda t: t.numpy(), params))
    with open(GOLDEN) as f:
        golden = json.load(f)
    req = golden["request"]
    audio = tone_bursts(req["seed"], sr=req["sr"], duration=req["duration"])
    table = seg.segment(audio, req["sr"], num_beams=req["num_beams"],
                        num_trials=req["num_trials"])
    assert json.loads(json.dumps(table)) == golden["table"]
    dsc = seg.default_segmentation_config
    clips, _ = seg.slice_audio_windows(audio, req["sr"], dsc["spec_time_step"],
                                       req["num_trials"])
    from whisperseg_torch.audio.frontend import Frontend

    tokens = seg._generate_tokens(
        clips, Frontend(req["sr"], dsc["spec_time_step"], dsc["min_frequency"]),
        4, int(dsc["max_length"]), req["num_beams"], 1.0)
    assert tokens == golden["tokens"]


def test_an_empty_directory_fails_as_jax_does(tmp_path):
    with pytest.raises(Exception) as theirs:
        jconv.import_hf_checkpoint(str(tmp_path))
    with pytest.raises(type(theirs.value)):
        Segmenter.from_pretrained(str(tmp_path), device="cpu")


@pytest.mark.parametrize("text", [
    "<|5|>12<|17|><|endoftext|>", "<|0|>3<|9|> <|10|>0<|20|>", "7",
    "<|startoftranscript|><|en|><|notimestamps|><|zebra_finch|>"])
def test_text_helpers_match_jax(text):
    ids = tokenizer.encode_text(text)
    assert ids == jtok.encode_text(text)
    assert tokenizer.decode_ids(ids) == jtok.decode_ids(ids) == text.replace(
        " ", "")
    assert (tokenizer.decode_ids(ids, skip_special_tokens=True)
            == jtok.decode_ids(ids, skip_special_tokens=True))
    ext = ids + [tokenizer.VOCAB_SIZE, tokenizer.VOCAB_SIZE + 5]
    assert (tokenizer.decode_ids(ext, extra_tokens=["12"])
            == jtok.decode_ids(ext, extra_tokens=["12"]))
    inv = {0: "a", 3: "b", 12: "c"}
    assert (codec.parse_segments_from_text(text, 0.01, inv)
            == jcodec.parse_segments_from_text(text, 0.01, inv))
    assert tokenizer.ID_TO_TOKEN == jtok.ID_TO_TOKEN
    assert tokenizer._build_id_to_token() == jtok._build_id_to_token()
    for bad in ("<|nope|>", "x"):
        with pytest.raises(ValueError):
            jtok.encode_text(bad)
        with pytest.raises(ValueError):
            tokenizer.encode_text(bad)
