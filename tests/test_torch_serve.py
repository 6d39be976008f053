"""The port's ``serve`` and ``selftest`` against kmer_tpu's.

In process, the command scripts of tests/test_api.py (queries,
mutations, GROUP and errors) go through both packages' executors over
tables made from the same rows, and every JSON answer and WAL entry must
be byte-identical.  The port's CLI runs in subprocesses (``--device
cpu``, each with a timeout) for what needs a process: kill -9 after
acknowledgements and a replay, a torn WAL tail, WALs written by one
package and replayed by the other, and concurrent TCP clients.  The
port's write-ahead order is checked too: when the log write fails, the
table is unchanged.
"""

import contextlib
import io
import json
import os
import socket
import subprocess
import sys
import threading
from pathlib import Path

import pytest

import kmer_tpu.cli as jax_cli
from kmer_tpu.api import KmerTable as JaxTable
from kmer_tpu_torch import cli
from kmer_tpu_torch.api import KmerTable
from kmer_tpu_torch.io.datagen import generate_test_rows, rows_to_csv

REPO = Path(__file__).resolve().parents[1]
TIMEOUT = 120

QUERIES = ["EQ acga", "PREFIX a", "PATTERN nn", "COUNT", "BOGUS",
           "EQ not-dna", "DISTINCT", "GROUP 5", "GROUP", "", "   ",
           "PATTERN angry", "PREFIX ", "EQ " + "t" * 33, "PATTERN u"]
MUTATIONS = ["COUNT", "INSERT acgtacgt,acgtacgt,acgtacgt", "COUNT",
             "EQ acgtacgt", "INSERT gattaca,gattacax,gattacax", "COUNT",
             "DELETE acgtacgt", "EQ acgtacgt", "COUNT"]
KILL9 = ["INSERT acgtacgt,acgtacgt,acgtacgt", "INSERT tttt,tttt,tttt",
         "DELETE tttt", "EQ acgtacgt"]
MIXED = ["GROUP 3", "INSERT acgt,acga,acga", "GROUP 3", "DISTINCT",
         "DELETEDNA acgt", "DELETEDNA acgt", "DELETEDNA nota-dna",
         "DELETE acga", "GROUP 3", "INSERT a,b", "INSERT a,,n",
         "INSERT AC , gg , rr", "EQ gg", "PATTERN rr", "delete gg",
         "DELETE", "EQ", "COUNT"]
SCRIPTS = {"queries": QUERIES, "mutations": MUTATIONS, "kill9": KILL9,
           "mixed": MIXED}


def _rows(n=40, seed=9):
    return generate_test_rows(n, seed=seed) + [("ac", "acga", "nn")]


def _answers(execute, script):
    out = []
    for line in script:
        r = execute(line)
        if r is not None:
            out.append(json.dumps(r))
    return out


@pytest.mark.parametrize("indexed", [False, True])
@pytest.mark.parametrize("script", list(SCRIPTS))
def test_executor_answers_match_kmer_tpu(script, indexed):
    port = KmerTable.from_rows(_rows(), device="cpu")
    ref = JaxTable.from_rows(_rows())
    if indexed:
        port.create_index()
        ref.create_index()
    port_log, ref_log = [], []
    got = _answers(cli._make_serve_executor(port, port_log.append),
                   SCRIPTS[script])
    want = _answers(jax_cli._make_serve_executor(ref, ref_log.append),
                    SCRIPTS[script])
    assert got == want
    assert [json.dumps(e) for e in port_log] == \
        [json.dumps(e) for e in ref_log]
    assert port.count() == ref.count()


@pytest.mark.parametrize("cmd, arg", [("INSERT", "acgt,acgt,acgt"),
                                      ("DELETE", "acga"),
                                      ("DELETEDNA", "ac")])
def test_failed_log_write_leaves_the_table_unchanged(cmd, arg):
    table = KmerTable.from_rows(_rows(), device="cpu")
    table.create_index()

    def durable(entry):
        raise OSError(28, "No space left on device")

    execute = cli._make_serve_executor(table, durable)
    before = _answers(execute, QUERIES + ["EQ acgt", "GROUP 100"])
    answer = execute(f"{cmd} {arg}")
    assert answer == {"error": "[Errno 28] No space left on device"}
    assert _answers(execute, QUERIES + ["EQ acgt", "GROUP 100"]) == before


def test_invalid_mutation_is_not_logged():
    table = KmerTable.from_rows(_rows(), device="cpu")
    log = []
    execute = cli._make_serve_executor(table, log.append)
    assert "error" in execute("INSERT acgt,acgx,nn")
    assert "error" in execute("DELETE not-a-kmer")
    assert "error" in execute("DELETEDNA u")
    assert log == [] and table.count() == 41


def test_wal_append_failure_truncates_the_partial_line(tmp_path,
                                                       monkeypatch):
    path = tmp_path / "w.wal"
    wal = cli._Wal(str(path))
    try:
        wal.append({"op": "delete_kmer", "q": "acga"})
        size = path.stat().st_size

        def fail(fd):
            raise OSError(5, "Input/output error")

        monkeypatch.setattr(os, "fsync", fail)
        with pytest.raises(OSError):
            wal.append({"op": "delete_kmer", "q": "tt"})
        monkeypatch.undo()
        assert path.stat().st_size == size
        wal.append({"op": "delete_kmer", "q": "cc"})
    finally:
        wal.close()
    assert [json.loads(ln)["q"] for ln in path.read_text().splitlines()] \
        == ["acga", "cc"]


# --- the CLI in subprocesses ----------------------------------------------------


def _serve_argv(csv, *extra):
    return [sys.executable, "-m", "kmer_tpu_torch", "serve", "--input",
            str(csv), "--device", "cpu", *extra]


def _serve(csv, commands, *extra):
    """Answers of one stdin run of the port's ``serve``."""
    p = subprocess.run(_serve_argv(csv, *extra),
                       input="\n".join(commands) + "\nQUIT\n",
                       capture_output=True, text=True, cwd=REPO,
                       timeout=TIMEOUT)
    assert p.returncode == 0, p.stderr
    return [json.loads(ln) for ln in p.stdout.strip().splitlines()]


@contextlib.contextmanager
def _server(csv, *extra):
    """A running ``serve`` subprocess, SIGKILLed on exit (and by a
    watchdog, so a hung server cannot hang the test)."""
    p = subprocess.Popen(_serve_argv(csv, *extra), stdin=subprocess.PIPE,
                         stdout=subprocess.PIPE, text=True, cwd=REPO)
    watchdog = threading.Timer(TIMEOUT, p.kill)
    watchdog.start()
    try:
        yield p
    finally:
        watchdog.cancel()
        p.kill()
        p.wait(timeout=TIMEOUT)


def test_serve_cli_answers(tmp_path):
    csv = tmp_path / "t.csv"
    rows_to_csv(_rows(), str(csv))
    lines = _serve(csv, QUERIES)
    assert lines[0] == {"ready": 41}
    want = _answers(jax_cli._make_serve_executor(
        JaxTable.from_csv(str(csv)), lambda e: None), QUERIES)
    assert [json.dumps(ln) for ln in lines[1:]] == want


def test_serve_wal_survives_kill9(tmp_path):
    csv = tmp_path / "t.csv"
    wal = str(tmp_path / "serve.wal")
    rows_to_csv(generate_test_rows(10, seed=3), str(csv))
    with _server(csv, "--wal", wal) as p:
        assert json.loads(p.stdout.readline())["ready"] == 10

        def ask(cmd):
            p.stdin.write(cmd + "\n")
            p.stdin.flush()
            return json.loads(p.stdout.readline())

        assert ask("INSERT acgtacgt,acgtacgt,acgtacgt")["inserted"] == 1
        assert ask("INSERT tttt,tttt,tttt")["inserted"] == 1
        assert ask("DELETE tttt")["deleted"] == 1
        assert ask("EQ acgtacgt")["rows"] == [10]
    # the kill came after the acks: the replay restores every mutation
    lines = _serve(csv, ["COUNT", "EQ acgtacgt", "EQ tttt"], "--wal", wal)
    assert lines == [{"ready": 11}, {"value": 11}, {"rows": [10]},
                     {"rows": []}]


def test_serve_wal_torn_tail_dropped_and_not_poisoned(tmp_path):
    csv = tmp_path / "t.csv"
    wal = tmp_path / "serve.wal"
    rows_to_csv(generate_test_rows(5, seed=8), str(csv))
    wal.write_text(json.dumps({"op": "insert",
                               "row": ["acgt", "acgt", "acgt"]}) + "\n"
                   + '{"op": "insert", "row": ["tt')  # torn mid-write
    lines = _serve(csv, ["COUNT", "INSERT gg,gggg,gggg"], "--wal", str(wal))
    assert lines[0] == {"ready": 6}  # 5 + the one complete insert
    assert lines[2] == {"inserted": 1}
    # both acknowledged inserts replay: the torn tail was truncated first
    lines = _serve(csv, ["COUNT", "EQ gggg"], "--wal", str(wal))
    assert lines[0] == {"ready": 7}
    assert len(lines[2]["rows"]) == 1
    assert all(json.loads(ln) for ln in wal.read_text().splitlines())


def _kmer_tpu_serve(argv, commands, monkeypatch):
    """kmer_tpu's ``serve`` run in this process; returns its answers."""
    monkeypatch.setenv("KMER_TPU_COMPILE_CACHE", "0")
    monkeypatch.setattr(sys, "stdin",
                        io.StringIO("\n".join(commands) + "\nQUIT\n"))
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        assert jax_cli.main(argv) == 0
    return [json.loads(ln) for ln in out.getvalue().strip().splitlines()]


CHECK = ["COUNT", "EQ acgtacgt", "EQ tttt", "EQ acga", "DISTINCT", "GROUP 4"]


def test_kmer_tpu_wal_replays_in_the_port(tmp_path, monkeypatch):
    csv = tmp_path / "t.csv"
    wal = str(tmp_path / "serve.wal")
    rows_to_csv(_rows(), str(csv))
    argv = ["serve", "--input", str(csv), "--wal", wal]
    _kmer_tpu_serve(argv, KILL9 + MIXED, monkeypatch)
    want = _kmer_tpu_serve(argv, CHECK, monkeypatch)
    assert _serve(csv, CHECK, "--wal", wal) == want


def test_port_wal_replays_in_kmer_tpu(tmp_path, monkeypatch):
    csv = tmp_path / "t.csv"
    wal = str(tmp_path / "serve.wal")
    rows_to_csv(_rows(), str(csv))
    _serve(csv, KILL9 + MIXED, "--wal", wal)
    got = _serve(csv, CHECK, "--wal", wal)
    argv = ["serve", "--input", str(csv), "--wal", wal]
    assert _kmer_tpu_serve(argv, CHECK, monkeypatch) == got


def test_serve_tcp_concurrent_clients(tmp_path):
    csv = tmp_path / "t.csv"
    rows_to_csv(generate_test_rows(30, seed=6) + [("ac", "acga", "nn")],
                str(csv))
    with _server(csv, "--tcp", "0") as p:
        ready = json.loads(p.stdout.readline())
        assert ready["ready"] == 31

        def client():
            s = socket.create_connection(("127.0.0.1", ready["tcp"]),
                                         timeout=TIMEOUT)
            return s, s.makefile("rw")

        def ask(f, cmd):
            f.write(cmd + "\n")
            f.flush()
            return json.loads(f.readline())

        conns = [client() for _ in range(4)]
        files = [f for _, f in conns]
        assert ask(files[0], "COUNT")["value"] == 31
        assert 30 in ask(files[1], "EQ acga")["rows"]
        # a mutation on one connection is visible to the others
        assert ask(files[1], "INSERT acgt,acga,acga")["inserted"] == 1
        assert ask(files[2], "COUNT")["value"] == 32
        assert sorted(ask(files[3], "EQ acga")["rows"])[-1] == 31
        # every client, hammering at once, answers as a stdin run
        # with the same insert does
        want = [json.dumps(r) for r in
                _serve(csv, ["INSERT acgt,acga,acga"] + QUERIES)[2:]]
        errs, answers = [], []

        def worker(f):
            try:
                for _ in range(5):
                    answers.append([json.dumps(ask(f, q)) for q in QUERIES
                                    if q.strip()])
            except Exception as e:  # raised again below
                errs.append(e)

        threads = [threading.Thread(target=worker, args=(f,))
                   for f in files]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=TIMEOUT)
            assert not t.is_alive()
        assert not errs, errs
        assert len(answers) == 20
        assert all(got == want for got in answers)
        for s, f in conns:
            f.close()
            s.close()


def test_selftest_cli():
    r = subprocess.run([sys.executable, "-m", "kmer_tpu_torch", "selftest",
                        "--device", "cpu"], capture_output=True, text=True,
                       cwd=REPO, timeout=TIMEOUT)
    assert r.returncode == 0, r.stderr
    assert r.stdout.startswith("selftest ok in ")
