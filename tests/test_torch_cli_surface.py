"""The `proqa-torch` CLI offers every command of the `proqa` CLI with the
same flags: the same subcommands, and for each the same option strings and
positionals with the same defaults, required-ness, action, choices and type,
apart from the departures named below, each recorded in ROADMAP.md's
Queue 3 under the heading it cites."""
import argparse
import os

import pytest

pytest.importorskip("torch")

from proqa_tpu.cli.main import build_parser as jax_parser  # noqa: E402
from proqa_tpu_torch.cli.main import build_parser as torch_parser  # noqa: E402

ROADMAP = os.path.join(os.path.dirname(__file__), os.pardir, "ROADMAP.md")

# (flag, what differs) -> the opening of the ROADMAP Queue 3 entry that records it
DEPARTURES = {
    # the port's one added flag, on every command that builds a model or
    # an index (the JAX package runs on its default backend)
    ("--device", "added"): "**`--device` on the commands that use a device",
    # the QA commands' sampler thread is off by default
    ("--prefetch", "default"): "**No prefetch thread by default in the QA path",
}


def _surface(parser) -> dict:
    """{subcommand: {flag or positional: (default, required, action, choices,
    type, dest)}}."""
    sub = next(a for a in parser._actions if isinstance(a, argparse._SubParsersAction))
    out = {}
    for name, sp in sub.choices.items():
        out[name] = {
            (a.option_strings[0] if a.option_strings else a.dest):
                (a.default, a.required, type(a).__name__, a.choices,
                 getattr(a.type, "__name__", None), a.dest)
            for a in sp._actions if not isinstance(a, argparse._HelpAction)
        }
    return out


def test_every_command_and_flag_exists():
    jax_cli, torch_cli = _surface(jax_parser()), _surface(torch_parser())
    assert set(torch_cli) == set(jax_cli)
    seen = set()
    for cmd, jflags in jax_cli.items():
        tflags = torch_cli[cmd]
        for flag in set(jflags) | set(tflags):
            if flag not in jflags:
                key = (flag, "added")
            elif flag not in tflags:
                key = (flag, "missing")
            elif tflags[flag] != jflags[flag]:
                diff = [i for i, (a, b) in enumerate(zip(tflags[flag], jflags[flag])) if a != b]
                key = (flag, "default" if diff == [0] else "other")
            else:
                continue
            assert key in DEPARTURES, f"{cmd} {flag}: {key[1]} ({tflags.get(flag)} vs " \
                                      f"{jflags.get(flag)})"
            seen.add(key)
    assert seen == set(DEPARTURES)


def test_departures_are_recorded_in_roadmap_queue_3():
    text = open(ROADMAP).read()
    queue3 = text[text.index("### Queue 3"):]
    queue3 = queue3[:queue3.index("\n## ")] if "\n## " in queue3 else queue3
    for entry in DEPARTURES.values():
        assert entry in queue3, entry
