"""WMT16 en-de (multi-lingual) — reference parity:
python/paddle/dataset/wmt16.py. Same triple format as wmt14 with
configurable vocab sizes."""

from . import wmt14


def train(src_dict_size=10000, trg_dict_size=10000, src_lang="en", n=2048):
    return wmt14._make_reader(n, 2, min(src_dict_size, trg_dict_size))


def test(src_dict_size=10000, trg_dict_size=10000, src_lang="en", n=256):
    return wmt14._make_reader(n, 3, min(src_dict_size, trg_dict_size))


def validation(src_dict_size=10000, trg_dict_size=10000, src_lang="en",
               n=256):
    return wmt14._make_reader(n, 4, min(src_dict_size, trg_dict_size))


def get_dict(lang, dict_size, reverse=False):
    d = {i: "%s_w%d" % (lang, i) for i in range(dict_size)}
    return d if reverse else {v: k for k, v in d.items()}


def fetch():
    pass
