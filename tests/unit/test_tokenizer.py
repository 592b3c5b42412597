"""The in-repo WordPiece tokenizer: training, round trip, and loading a
HuggingFace-format tokenizer.json."""

import json

import numpy as np

from cloudvectordb_tpu.data.synthetic import synthetic_corpus
from cloudvectordb_tpu.data.tokenize import TextTokenizer, pre_tokenize


def test_pre_tokenize_bert_normalisation():
    assert pre_tokenize("Héllo, WORLD!  foo-bar\tbaz") == [
        "hello", ",", "world", "!", "foo", "-", "bar", "baz"]


def test_train_encode_decode_round_trip(tmp_path):
    corpus = synthetic_corpus(300, seed=4)
    tok = TextTokenizer.train(corpus, vocab_size=400, max_len=48)
    assert tok.vocab_size <= 400
    ids, mask = tok.encode_batch(corpus[:20])
    assert ids.shape == (20, 48) and mask.dtype == np.int32
    for row, text in zip(range(20), corpus[:20]):
        n = int(mask[row].sum())
        if n < 48:  # untruncated rows decode back to the normalised text
            assert tok.decode(ids[row, :n]) == " ".join(pre_tokenize(text))
    tok.save(tmp_path / "tokenizer.json")
    again = TextTokenizer.load(tmp_path / "tokenizer.json", max_len=48)
    np.testing.assert_array_equal(again.encode_batch(corpus[:20])[0], ids)


def test_load_hf_tokenizer_json_fixture(tmp_path):
    """A BERT-style tokenizer.json as HuggingFace writes it (WordPiece
    model, BertNormalizer, [CLS] $A [SEP] template)."""
    vocab = {"[PAD]": 0, "[UNK]": 1, "[CLS]": 2, "[SEP]": 3, "the": 4,
             "tele": 5, "##scope": 6, "galaxy": 7, "##s": 8, ",": 9}
    spec = {
        "version": "1.0",
        "added_tokens": [{"id": i, "content": t, "special": True}
                         for t, i in list(vocab.items())[:4]],
        "normalizer": {"type": "BertNormalizer", "clean_text": True,
                       "handle_chinese_chars": True, "strip_accents": None,
                       "lowercase": True},
        "pre_tokenizer": {"type": "BertPreTokenizer"},
        "post_processor": {"type": "TemplateProcessing"},
        "model": {"type": "WordPiece", "unk_token": "[UNK]",
                  "continuing_subword_prefix": "##",
                  "max_input_chars_per_word": 100, "vocab": vocab},
    }
    path = tmp_path / "tokenizer.json"
    path.write_text(json.dumps(spec))
    tok = TextTokenizer.load(path, max_len=12)
    ids, mask = tok.encode_batch(["The Telescopes, the GALAXY quasar"])
    assert ids[0].tolist() == [2, 4, 5, 6, 8, 9, 4, 7, 1, 3, 0, 0]
    assert mask[0].tolist() == [1] * 10 + [0] * 2
    assert tok.vocab_size == 10 and tok.pad_id == 0
