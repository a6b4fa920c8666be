"""``cli/conv_phases.py``'s variants against the kernels' sources, on the
CPU: each takes its phase out by text substitutions that must apply to
the sources as they stand (a change that moves a phase would otherwise
fail only on the card), and the P1 and P10/P15 variants never leave a
wait on copies they took out."""

import pytest

from hvi_cidnet_torch.cli import conv_phases as cp
from hvi_cidnet_torch.ops import _build
from _torch_port import one_torch_thread  # noqa: F401


def _apply(src, subs):
    texts = {src: (_build.CSRC_DIR / src).read_text()}
    for sub in subs:
        file, old, new = sub if len(sub) == 3 else (src, *sub)
        text = texts.setdefault(file, (_build.CSRC_DIR / file).read_text())
        assert old in text, f"{src}: {old[:60]!r} not in {file}"
        texts[file] = text.replace(old, new)
    return texts


@pytest.mark.parametrize("key", list(cp.VARIANTS), ids=lambda k: f"{k[0]}-{k[1]}")
def test_conv_phases_variant_applies(key):
    src, name = key
    texts = _apply(src, cp.VARIANTS[key])
    if name == "base":
        assert texts[src] == (_build.CSRC_DIR / src).read_text()
    else:
        assert any(texts[f] != (_build.CSRC_DIR / f).read_text() for f in texts)


@pytest.mark.parametrize("src", ["head_attention.cu", "batched_qk.cu"])
def test_conv_phases_no_copies_leaves_no_wait_on_bulk_copies(src):
    """Without copies an mbarrier wait would never return: the variant
    takes the waits out with the copies."""
    texts = _apply(src, cp.VARIANTS[src, "no_copies"])
    merged = "".join(texts.values())
    assert "bulk_stage(" not in merged.replace("void bulk_stage(", "")
    assert "mbar_wait(sm.bars" not in merged
