"""The train CLI's elastic resume on a narrow transformer with a bf16
second moment, per-step and at ``--steps-per-dispatch 2``: the checks of
``tests/test_torch_train_resume.py`` (killed at step 5, resumed with
``--resume auto``, the committed crc signature equal to the
uninterrupted run's, the ``kind=resume`` / ``ckpt_drain`` / ``goodput``
records) on the transformer's train state.
"""

import pytest
import torch

from test_torch_train_resume import (DISPATCH, check_bitwise,
                                     check_records, killed_and_resumed,
                                     whole_run)

torch.set_num_threads(1)


@pytest.fixture(scope="module")
def whole(tmp_path_factory):
    return whole_run(tmp_path_factory, "tiny_tf")


@pytest.fixture(scope="module", params=list(DISPATCH))
def drill(request, tmp_path_factory, whole):
    return killed_and_resumed(tmp_path_factory, "tiny_tf", request.param,
                              whole)


def test_killed_run_resumes_bitwise(drill):
    check_bitwise(drill)


def test_resume_drain_and_goodput_records(drill):
    check_records(drill)
