"""The port's MedCLIP tokenizer (``models/medclip/tokenizer.py``) against
``transformers``' BERT tokenizers on a ``vocab.txt`` and
``tokenizer_config.json`` written here: ``AutoTokenizer.from_pretrained``
(the fast tokenizer, which it follows) and ``BertTokenizer`` (the slow
one), with ``do_lower_case`` both ways; and the JAX package's
``SemanticLossFn.tokenize`` with the ``transformers`` tokenizer against the
port's with its own. Only this test imports ``transformers``; the port
never does."""

import json
import string
import unicodedata

import numpy as np
import pytest
from hypothesis import given, settings
from hypothesis import strategies as st

from m2trans_tpu.losses import semantic as jsem
from m2trans_tpu_torch.losses import semantic
from m2trans_tpu_torch.models.medclip.tokenizer import WordPieceTokenizer

CAPTIONS = [  # scripts/train_full_recipe.py's six
    "longitudinal view of the carotid artery with clear intima",
    "transverse liver section with homogeneous echotexture",
    "thyroid nodule with well defined hypoechoic margin",
    "kidney cortex and medulla with normal echogenicity",
    "breast lesion with posterior acoustic enhancement",
    "gallbladder wall without thickening or stones",
]
EXTRA = [
    "Liver, kidney!! (normal)... 3.5cm; [note]: {x}",
    "Café résumé naïve Über ÉCHO",
    "carotid\tartery\nliver\r\nsection view",
    "x" * 101,
    "a" * 100,
    "[CLS] liver [SEP] [MASK] [UNK] [cls] liver[PAD]kidney",
    " ".join(["liver"] * 40),
    "中文 liver 肝",
    "a\x00b�c\x07d​node",
    "",
    "   ",
    "é liver",
]
ACCENTED = "àáâäçèéêëìíîïñòóôöùúûüýÀÁÂÄÇÈÉÊËÌÍÎÏÑÒÓÔÖÙÚÛÜÝß"
WORDS = sorted({w for c in CAPTIONS for w in c.split()})
VOCAB = (["[PAD]", "[UNK]", "[CLS]", "[SEP]", "[MASK]"] + WORDS
         + list(string.ascii_lowercase + string.digits) + list(string.punctuation)
         + ["##" + c for c in string.ascii_lowercase + string.digits]
         + ["##ing", "##s", "caf", "##é", "é", "Liver", "CAF", "##É", "e", "ü", "über",
            "uber", "##ve", "na", "##ï", "écho", "echo", "résumé", "resume", "中", "肝"])


@pytest.fixture(scope="module", params=[True, False], ids=["lower", "cased"])
def toks(request, tmp_path_factory):
    """(the port's, the fast, the slow tokenizer) of one directory."""
    from transformers import AutoTokenizer, BertTokenizer

    d = tmp_path_factory.mktemp("medclip")
    (d / "vocab.txt").write_text("\n".join(VOCAB) + "\n", encoding="utf-8")
    (d / "tokenizer_config.json").write_text(json.dumps(
        {"tokenizer_class": "BertTokenizer", "do_lower_case": request.param}))
    fast = AutoTokenizer.from_pretrained(str(d))
    assert type(fast).__name__ == "BertTokenizerFast"
    return (WordPieceTokenizer.from_dir(str(d)), fast,
            BertTokenizer.from_pretrained(str(d)), request.param)


def _call(tok, texts, max_length):
    return tok(texts, return_tensors="np", padding="max_length", truncation=True,
               max_length=max_length)


def _equal(got, want):
    for k in ("input_ids", "attention_mask", "token_type_ids"):
        np.testing.assert_array_equal(got[k], np.asarray(want[k]), err_msg=k)


@pytest.mark.parametrize("max_length", [64, 8])
@pytest.mark.parametrize("text", CAPTIONS + EXTRA)
def test_matches_transformers(toks, text, max_length):
    """Ids, mask and token types equal the fast tokenizer's; the slow one's
    too, but where it composes a letter and a combining accent (NFC) that
    the fast one, and the port, keep apart."""
    mine, fast, slow, lower = toks
    got = _call(mine, [text], max_length)
    _equal(got, _call(fast, [text], max_length))
    composed = any(unicodedata.combining(c) for c in text) and not lower
    if not composed:
        _equal(got, _call(slow, [text], max_length))


def test_batch(toks):
    """A batch of rows of several lengths; the call takes only what
    ``SemanticLossFn.tokenize`` asks for."""
    mine, fast, _, _ = toks
    got = _call(mine, CAPTIONS + EXTRA, 16)
    _equal(got, _call(fast, CAPTIONS + EXTRA, 16))
    assert got["input_ids"].dtype == np.int64
    with pytest.raises(ValueError, match="padding='max_length'"):
        mine(CAPTIONS, return_tensors="np", padding="longest", max_length=16)


@settings(max_examples=60, deadline=None)
@given(text=st.text(alphabet=string.ascii_letters + string.digits + string.punctuation
                    + " \t\n" + ACCENTED, max_size=80))
def test_property_matches_fast(toks, text):
    mine, fast, _, _ = toks
    _equal(_call(mine, [text], 32), _call(fast, [text], 32))


def test_semantic_tokenize_matches_jax(toks):
    """The JAX SemanticLossFn.tokenize with the ``transformers`` tokenizer
    and the port's with its own give equal int32 arrays."""
    mine, fast, _, _ = toks
    want = jsem.SemanticLossFn(None, None, fast, max_length=24).tokenize(CAPTIONS + EXTRA)
    got = semantic.SemanticLossFn(None, None, mine, max_length=24).tokenize(CAPTIONS + EXTRA)
    assert set(got) == set(want)
    for k in want:
        assert got[k].dtype == np.int32
        np.testing.assert_array_equal(got[k], want[k])


def test_missing_vocab_names_the_file(tmp_path):
    with pytest.raises(FileNotFoundError, match="vocab.txt"):
        WordPieceTokenizer.from_dir(str(tmp_path))


def test_defaults_without_config(tmp_path):
    """No tokenizer_config.json: BertTokenizer's defaults (lower case,
    accents stripped, CJK spaced out)."""
    (tmp_path / "vocab.txt").write_text("\n".join(VOCAB) + "\n", encoding="utf-8")
    tok = WordPieceTokenizer.from_dir(str(tmp_path))
    assert tok.tokenize("Café 中x") == ["caf", "##e", "中", "x"]
