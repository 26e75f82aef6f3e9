"""The port's CLIP tokenizer (stable_diffusion_tpu_torch/tokenizer.py) gives
``transformers.CLIPTokenizer``'s ids (without ftfy, as the JAX pipeline
runs it) on the same synthesized vocabulary, for both pad conventions:
SD1.5's files pad with <|endoftext|>, SD2.1's with "!" (id 0).

The vocabulary is CLIP's layout at a small size: the 256 byte symbols,
their </w> forms, merges learned greedily here from a fixed text, then the
two special tokens."""

import collections
import json
import sys
import unicodedata

import numpy as np
import pytest
import regex

from stable_diffusion_tpu_torch import tokenizer as T
from tests.torch_threads import one_thread  # noqa: F401

TEXT = ("a photo of a cat sitting on the mat, a painting of a dog in the style of van gogh. "
        "an astronaut riding a horse on the moon; highly detailed, 4k, trending on artstation. "
        "the quick brown fox jumps over the lazy dog! it's a beautiful day, we'll see. "
        "portrait of a woman with red hair, oil on canvas, by greg rutkowski and alphonse mucha. "
        "café crème brûlée naïve façade, 東京の夜景, 北京 上海, ½ ⅓ Ⅻ 3.14159 100% #1 @home ")
N_MERGES = 150

PROMPTS = [
    "", " ", "a", "a photo of a cat", "A Photo Of A CAT", "an astronaut riding a horse on the moon",
    "it's", "we'll", "they're", "I've", "I'm", "he'd", "don't", "IT'S", "it’s (curly)",
    "hello!", "hello!!!", "!!!", "a,b;c.d:e", "(parentheses) [brackets] {braces}", "#hashtag @user",
    "100%", "3.14159", "year 2024", "1234567890", "x=y+z*2/3-1", "~`^|\\", "snake_case_word",
    "café", "CAFÉ crème brûlée", "naïve façade", "Ångström", "straße", "ÉCOLE", "çà et là",
    "東京の夜景", "北京 上海", "日本語とEnglish", "한국어 텍스트", "Привет мир", "γειά σου κόσμε",
    "½ cup", "⅓", "Ⅻ o'clock", "²³", "٣ arabic digit", "①②③",
    "tab\there", "new\nline", "carriage\rreturn", "bell\x07char", "nul\x00char", "zero​width",
    "non breaking", "em space", "line sep", "�replacement", "emoji 😀🎨",
    "<|endoftext|>", "a <|startoftext|> b", "x<|endoftext|>y", "<|ENDOFTEXT|>", "ſ 'ſ", "aͅb",
    "é combining", "ﬁ ligature", "İstanbul", "a photo of <cat-toy> on the moon",
    " ".join(["word"] * 90),
    "a photo of " + ", ".join(f"thing{i}" for i in range(60)),
]


def _learn_merges(text, n):
    """Greedy BPE on the byte-mapped pieces of ``text`` (CLIP's symbols,
    the last of a word ending in </w>): the most frequent adjacent pair,
    ties by first appearance, ``n`` times."""
    enc = T.bytes_to_unicode()
    words = collections.Counter()
    for piece in T.clip_pattern().findall(T.basic_clean(text)):
        mapped = "".join(enc[b] for b in piece.encode("utf-8"))
        words[tuple(mapped[:-1]) + (mapped[-1] + "</w>",)] += 1
    merges = []
    for _ in range(n):
        pairs = collections.Counter()
        for w, c in words.items():
            for p in zip(w, w[1:]):
                pairs[p] += c
        if not pairs:
            break
        best = max(pairs, key=lambda p: pairs[p])
        merges.append(best)
        merged = collections.Counter()
        for w, c in words.items():
            out, i = [], 0
            while i < len(w):
                if i < len(w) - 1 and (w[i], w[i + 1]) == best:
                    out.append(w[i] + w[i + 1])
                    i += 2
                else:
                    out.append(w[i])
                    i += 1
            merged[tuple(out)] += c
        words = merged
    return merges


@pytest.fixture(scope="module")
def vocab_dir(tmp_path_factory):
    root = tmp_path_factory.mktemp("tok")
    symbols = list(T.bytes_to_unicode().values())
    tokens = symbols + [s + "</w>" for s in symbols]
    merges = _learn_merges(TEXT, N_MERGES)
    tokens += ["".join(m) for m in merges]
    tokens += ["<|startoftext|>", "<|endoftext|>"]
    vocab = {}
    for t in tokens:
        vocab.setdefault(t, len(vocab))
    (root / "vocab.json").write_text(json.dumps(vocab, ensure_ascii=False), encoding="utf-8")
    (root / "merges.txt").write_text("#version: 0.2\n" + "\n".join(" ".join(m) for m in merges) + "\n",
                                     encoding="utf-8")
    return root


def _configure(root, sub, pad, added=None):
    """A tokenizer directory with ``pad`` as its pad token (SD2.1's
    tokenizer_config.json names it, as its file does) and ``added`` tokens
    after the vocabulary (``added_tokens_decoder``, as a textual-inversion
    export lists them)."""
    d = root / sub
    d.mkdir(exist_ok=True)
    for name in ("vocab.json", "merges.txt"):
        (d / name).write_bytes((root / name).read_bytes())
    if pad is not None:
        tok = {"__type": "AddedToken", "lstrip": False, "normalized": True, "rstrip": False,
               "single_word": False}
        cfg = {"bos_token": dict(tok, content="<|startoftext|>"),
               "eos_token": dict(tok, content="<|endoftext|>"),
               "unk_token": dict(tok, content="<|endoftext|>"), "pad_token": pad,
               "do_lower_case": True, "model_max_length": 77, "tokenizer_class": "CLIPTokenizer"}
        if added:
            n = len(json.loads((root / "vocab.json").read_text(encoding="utf-8")))
            cfg["added_tokens_decoder"] = {str(n + i): dict(tok, content=t, normalized=False, special=False)
                                           for i, t in enumerate(added)}
        (d / "tokenizer_config.json").write_text(json.dumps(cfg))
    return d


@pytest.mark.parametrize("convention", ["sd15_no_config", "sd15", "sd21", "sd21_added_token"])
def test_ids_equal_transformers(vocab_dir, convention):
    from transformers import CLIPTokenizer as HF

    pad = {"sd15_no_config": None, "sd15": "<|endoftext|>"}.get(convention, "!")
    d = _configure(vocab_dir, convention, pad, ["<cat-toy>"] if "added" in convention else None)
    hf = HF.from_pretrained(str(d))
    assert getattr(hf, "fix_text", None) is None  # no ftfy: the BasicTokenizer branch
    ours = T.load_tokenizer(str(d))
    want = hf.batch_encode_plus(PROMPTS, padding="max_length", max_length=77, truncation=True)
    got = ours.batch_encode_plus(PROMPTS, padding="max_length", max_length=77, truncation=True)
    assert len(PROMPTS) >= 50
    for p, w, g in zip(PROMPTS, want.input_ids, got.input_ids):
        assert g == w, p
    assert ours.pad_token_id == hf.pad_token_id == (0 if pad == "!" else ours.eos_token_id)
    for p in PROMPTS:
        assert ours.tokenize(p) == hf.tokenize(p), p
    # the long prompts were cut to 75 ids between bos and eos
    assert got.input_ids[-1][0] == ours.bos_token_id and got.input_ids[-1][76] == ours.eos_token_id


@pytest.mark.parametrize("convention", ["sd15", "sd21"])
def test_call_and_pad_equal_transformers(vocab_dir, convention):
    """What the trainer's dataset asks of its tokenizer: ``tok(prompt,
    padding="do_not_pad", truncation=True, max_length=77).input_ids`` and
    ``tok.pad({"input_ids": rows}, padding="max_length", max_length=77,
    return_tensors="np")["input_ids"]``, and a list of prompts padded in the
    call, as ``transformers.CLIPTokenizer`` gives them."""
    from transformers import CLIPTokenizer as HF

    d = _configure(vocab_dir, convention, "<|endoftext|>" if convention == "sd15" else "!")
    hf, ours = HF.from_pretrained(str(d)), T.load_tokenizer(str(d))
    kw = dict(padding="do_not_pad", truncation=True, max_length=77)
    rows = [ours(p, **kw).input_ids for p in PROMPTS]
    assert rows == [hf(p, **kw).input_ids for p in PROMPTS]
    assert max(map(len, rows)) == 77 and min(map(len, rows)) == 2
    pad = dict(padding="max_length", max_length=77, return_tensors="np")
    got = ours.pad({"input_ids": rows}, **pad)["input_ids"]
    want = hf.pad({"input_ids": rows}, **pad)["input_ids"]
    assert got.dtype == want.dtype == np.int64
    np.testing.assert_array_equal(got, want)
    both = dict(padding="max_length", truncation=True, max_length=77)
    assert ours(PROMPTS[:3], **both).input_ids == hf(PROMPTS[:3], **both).input_ids
    with pytest.raises(ValueError, match="longer"):
        ours.pad({"input_ids": [[1] * 78]}, padding="max_length", max_length=77)


def test_merges_were_learned_and_used(vocab_dir):
    """The vocabulary carries real merges, so the BPE loop is exercised:
    a frequent word is one symbol, an unseen one many."""
    tok = T.load_tokenizer(str(vocab_dir))
    assert len(tok.bpe_ranks) == N_MERGES
    assert tok.tokenize("the") == ["the</w>"]
    assert len(tok.tokenize("zyxwvu")) > 1


def test_pattern_classes_equal_regex_over_all_code_points():
    """The letter and number classes built from unicodedata equal the
    ``regex`` package's \\p{L} / \\p{N} (case-insensitive) on every code
    point that survives the clean-up (control and unassigned characters are
    dropped and the text lower-cased before the pattern runs), alone,
    between letters and digits, and after an apostrophe."""
    ref = regex.compile(r"""<\|startoftext\|>|<\|endoftext\|>|'s|'t|'re|'ve|'m|'ll|'d|[\p{L}]+|[\p{N}]|[^\s\p{L}\p{N}]+""",
                        regex.IGNORECASE)
    chars = [chr(cp) for cp in range(sys.maxunicode + 1)
             if not 0xD800 <= cp <= 0xDFFF and not unicodedata.category(chr(cp)).startswith("C")
             and not chr(cp).isspace()]
    text = T.basic_clean(" ".join(f"{c}{c} a{c}1 '{c}" for c in chars))  # what reaches it
    assert T.clip_pattern().findall(text) == ref.findall(text)


def test_plain_re_shortcuts_are_not_the_classes():
    """Why the classes are built: ``[^\\W\\d_]`` also takes the Nl/No numerals
    and ``\\d`` misses them."""
    import re

    assert re.fullmatch(r"[^\W\d_]", "½") and not regex.fullmatch(r"\p{L}", "½")
    assert not re.fullmatch(r"\d", "Ⅻ") and regex.fullmatch(r"\p{N}", "Ⅻ")
    assert T.clip_pattern().findall("½Ⅻab") == ["½", "Ⅻ", "ab"]


def test_basic_clean_matches_transformers():
    from transformers.models.clip.tokenization_clip import BasicTokenizer

    bt = BasicTokenizer(strip_accents=False, do_split_on_punc=False)
    for p in PROMPTS:
        assert T.basic_clean(p) == " ".join(bt.tokenize(p)), p


def test_missing_files_raise(tmp_path):
    with pytest.raises(FileNotFoundError, match="vocab.json"):
        T.load_tokenizer(str(tmp_path))


def test_ids_are_numpy_friendly(vocab_dir):
    ids = np.asarray(T.load_tokenizer(str(vocab_dir)).batch_encode_plus(["a cat", ""]).input_ids)
    assert ids.shape == (2, 77) and ids.dtype.kind == "i"
