"""A run with the timed path broken underneath comes out not correct.

Each test drives a whole run at the CPU test size, past the harness's look
for a card, with one fault planted in the program under the window: an
answer altered where it is produced (the output ciphertext, and the
client's logits), a layer step that returns its state unchanged, and half
of the request's tokens left out.  The cells run on one card, so there is
no exchange between cards to leave out."""

from __future__ import annotations

import numpy as np
import pytest
from conftest import tiny_cell

from port_bench import harness, run

SEED = 2 ** 32 + 5


def _measure(kind, fault):
    """run.measure with `fault(prog)` applied after the warm-up, so the
    window's requests are the broken ones."""
    orig = harness.window

    def broken(cell, prog, *args, **kw):
        fault(prog)
        return orig(cell, prog, *args, **kw)
    harness.window = broken
    try:
        return run.measure(tiny_cell(kind), SEED, 0.1, False, device="cpu")
    finally:
        harness.window = orig


def _alter_ciphertext(prog):
    circ, ev = prog.circ, prog.ev
    pooler = circ.pooler_classifier

    def altered(*args, **kw):
        out = pooler(*args, **kw)
        bump = np.zeros(ev.ctx.cfg.slots)
        bump[0] = 0.05
        return ev.add_plain(out, ev.encode(bump, nl=out.nl, scale=out.scale))
    circ.pooler_classifier = altered


def _alter_client_logits(prog):
    decrypt = prog.decrypt
    prog.decrypt = lambda out: decrypt(out) + np.eye(len(decrypt(out)))[1] \
        * 0.05


def _ffn_returns_its_input(prog):
    prog.circ.ffn = lambda x, *args, **kw: x


def _half_the_tokens(prog):
    enc = prog.circ.encrypt_inputs
    prog.circ.encrypt_inputs = lambda emb, *a, **kw: enc(
        emb[: len(emb) // 2], *a, **kw)


@pytest.mark.parametrize("kind,fault", [
    ("packed", _alter_ciphertext),
    ("pertoken", _alter_client_logits),
    ("packed", _ffn_returns_its_input),
    ("pertoken", _half_the_tokens),
])
def test_fault_is_not_correct(kind, fault):
    res = _measure(kind, fault)
    assert res["attempted"] >= 1
    assert not res["correct"], res["verdict"]
