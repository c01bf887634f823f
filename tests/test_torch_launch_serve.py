"""The port's serve launcher against the reference's: the same options
with the same defaults, and the port's ``--impl`` values served.

Both launchers build their parser inside ``main``; a patched
``ArgumentParser.parse_args`` hands the parser over before anything is
parsed or built.  The reference's parser is read; nothing in the reference
changes.
"""
import argparse
import logging

import pytest

from repro.launch import serve as ref_serve
from repro_torch.launch import serve as port_serve

# options whose default or choices differ on purpose (ROADMAP §3)
DELIBERATE = {
    "--impl": "the port's values: cuda (the kernels) or plain, not xla or "
              "pallas",
    "--beam": "None: 8 under --config small (the reference's), 70 under "
              "static_gr",
}
PORT_ONLY = {"--config", "--device", "--seed"}


class _Parsed(Exception):
    pass


def _parser(monkeypatch, main, *argv):
    """The parser ``main`` builds, taken at its ``parse_args``."""
    box = {}

    def grab(self, *a, **k):
        box["parser"] = self
        raise _Parsed

    monkeypatch.setattr(argparse.ArgumentParser, "parse_args", grab)
    with pytest.raises(_Parsed):
        main(*argv)
    return box["parser"]


def _options(parser):
    """``{option string: action}`` of every optional argument but -h."""
    return {a.option_strings[-1]: a for a in parser._actions
            if a.option_strings and a.dest != "help"}


@pytest.fixture
def parsers(monkeypatch):
    return (_options(_parser(monkeypatch, ref_serve.main)),
            _options(_parser(monkeypatch, port_serve.main, [])))


def test_every_reference_option_is_in_the_port(parsers):
    ref, port = parsers
    assert set(ref) <= set(port), sorted(set(ref) - set(port))
    assert set(port) - set(ref) == PORT_ONLY


def test_defaults_and_choices_match_the_reference(parsers):
    ref, port = parsers
    for name, a in ref.items():
        if name in DELIBERATE:
            continue
        assert port[name].default == a.default, name
        assert set(port[name].choices or ()) == set(a.choices or ()), name
        assert type(port[name]) is type(a), name  # store / store_true


def test_deliberate_differences(parsers):
    ref, port = parsers
    assert ref["--impl"].choices == ["xla", "pallas"]
    assert port["--impl"].choices == ["cuda", "plain"]
    assert port["--impl"].default == "cuda"
    assert ref["--beam"].default == 8 and port["--beam"].default is None
    assert set(DELIBERATE) <= set(ref)


@pytest.mark.parametrize("impl,step", [("plain", "vntk[plain+topk]"),
                                       ("cuda", "vntk[auto+topk]")])
def test_impl_picks_the_constraint_step(caplog, impl, step):
    """``--impl plain`` serves the plain step (also on the card); the
    default the kernels (their plain versions on CPU tensors).  The
    reference's --vocab, --sid-length and --log-level are taken."""
    argv = ["--constraints", "300", "--vocab", "64", "--sid-length", "3",
            "--beam", "4", "--batch", "2", "--requests", "1", "--device",
            "cpu", "--impl", impl, "--log-level", "INFO"]
    with caplog.at_level(logging.INFO, logger="repro_torch.launch.serve"):
        assert port_serve.main(argv) == 0
    plans = [r.getMessage() for r in caplog.records
             if "policy" in r.getMessage()]
    assert plans and f"L2:{step}" in plans[0]  # L = 3: one sparse level


def test_static_gr_refuses_another_sid_shape():
    with pytest.raises(SystemExit):
        port_serve.main(["--config", "static_gr", "--vocab", "64",
                         "--device", "cpu"])
