"""The port's dry-run against XLA's ``argument_size_in_bytes`` and output
shapes for reduced jamba's train step on (2, 2), (16, 16) and (2, 16, 16),
the slowest cases of ``dryrun_cases.py`` to compile in the reference (the
others: ``test_torch_dryrun_run.py`` and ``_zoo``)."""

import pytest

import dryrun_cases as C
from test_torch_dryrun_run import check_case, reference

PICK = ["jamba-v0.1-52b:train"]
CASES = [c for c in C.cases() if C.selected(c[0], PICK)]


@pytest.fixture(scope="module")
def ref(tmp_path_factory):
    return reference(tmp_path_factory.mktemp("dryrun_jamba"), PICK)


@pytest.mark.parametrize("case", CASES, ids=[c[0] for c in CASES])
def test_argument_bytes_and_outputs_match_the_reference(ref, case):
    check_case(ref, case)
