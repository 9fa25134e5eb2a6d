"""The port's CLI (``python -m paillier_tpu_torch.cli``) against the JAX
package's (``python -m paillier_tpu.cli``).

With ``--cpu --seed 1`` at tiny sizes each subcommand of the port prints
the lines that the JAX CLI prints with the same flags (``JAX_LINES``,
recorded from ``paillier_tpu.cli``; ``test_jax_cli_prints_the_recorded
_lines``, marked slow, runs the JAX CLI again and holds it to them:
≈ 3 min of JAX compiles on the CPU).  The one line that may differ is
the tensor's dtype (uint32 limbs there, int64 here).
"""

import io
from contextlib import redirect_stdout

import pytest

from paillier_tpu_torch import cli

RUNS = {
    "demo": ["--cpu", "--seed", "1", "demo", "--bits", "128"],
    "threshold": ["--cpu", "--seed", "1", "threshold", "--bits", "64"],
    "ddleq": ["--cpu", "--seed", "1", "ddleq", "--bits", "128", "--secpar",
              "8"],
}

JAX_LINES = {
    "demo": [
        "generating 128-bit keypair...",
        "  n = 0xcd324931151bb09f0c19eeb02172dde5",
        "encrypting [101, 202, 303, 404] (batched on device)...",
        "  ciphertext tensor: (4, 16) uint32",
        "homomorphic sum     -> 1010  (expected 1010)",
        "const_mult by 3     -> [303, 606, 909, 1212]",
        "homomorphic sub     -> [100, 200, 300, 400]",
        "ok"],
    "threshold": [
        "generating (3,5)-threshold keys (64-bit)...",
        "servers [1, 2, 3] decrypting batch [1, 0, 1, 1, 0]...",
        "combined -> [1, 0, 1, 1, 0]",
        "ok"],
    "ddleq": [
        "nested-encrypting 2 values, re-randomizing...",
        "proving DDLEQ (secpar=8)...",
        "verify -> [True, True]",
        "ok"],
}


def _run(main, argv) -> list[str]:
    buf = io.StringIO()
    with redirect_stdout(buf):
        main(argv)
    return buf.getvalue().splitlines()


@pytest.mark.parametrize("cmd", sorted(RUNS))
def test_cli_prints_the_jax_cli_lines(cmd):
    got = _run(cli.main, RUNS[cmd])
    want = [ln.replace("uint32", "int64") for ln in JAX_LINES[cmd]]
    assert got == want


@pytest.mark.parametrize("cmd", sorted(RUNS))
def test_cli_runs_on_the_card_unless_asked(cmd, monkeypatch):
    """Without --cpu every subcommand hands its entry points
    device="cuda"; with it, "cpu"."""
    seen = []
    name = {"demo": "_demo", "threshold": "_threshold", "ddleq": "_ddleq"}
    monkeypatch.setattr(cli, name[cmd],
                        lambda args, dev: seen.append((args.cmd, dev)))
    cli.main(RUNS[cmd][1:])
    cli.main(RUNS[cmd])
    assert seen == [(cmd, "cuda"), (cmd, "cpu")]


def test_cli_flags_match_the_jax_cli():
    """Each subcommand takes the JAX CLI's flags and defaults."""
    import argparse
    from paillier_tpu import cli as jcli

    def flags(main):
        seen = {}
        real = argparse.ArgumentParser.parse_args

        def spy(self, argv=None, namespace=None):
            ns = real(self, argv, namespace)
            seen[ns.cmd] = dict(vars(ns))
            raise SystemExit(0)

        argparse.ArgumentParser.parse_args = spy
        try:
            for cmd in RUNS:
                with pytest.raises(SystemExit):
                    main([cmd])
        finally:
            argparse.ArgumentParser.parse_args = real
        return seen

    assert flags(cli.main) == flags(jcli.main)


@pytest.mark.slow
@pytest.mark.parametrize("cmd", sorted(RUNS))
def test_jax_cli_prints_the_recorded_lines(cmd):
    from paillier_tpu import cli as jcli
    assert _run(jcli.main, RUNS[cmd]) == JAX_LINES[cmd]
