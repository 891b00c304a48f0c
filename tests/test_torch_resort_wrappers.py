"""The resort wrappers' argument checks, permute_slots' operands (the cases
of test_resort_wrappers_check_arguments that test_torch_kernels.py, which
holds src_rows_from_order's, leaves here so that no port test file holds
more than 14 tests).
"""

import pytest
import torch

from test_torch_kernels import check_resort_wrapper

torch.set_num_threads(1)


@pytest.mark.parametrize("fault", ["dtype", "shape", "device", "contiguous"])
@pytest.mark.parametrize("wrapper,arg", [("permute_slots", 0), ("permute_slots", 2),
                                         ("permute_slots", 3)])
def test_resort_wrappers_check_arguments(wrapper, arg, fault):
    """The two resort wrappers (after their launch path was made cheaper)
    still raise on an operand of another dtype (TypeError), shape, device or
    a non-contiguous one (ValueError), and on the CPU run their plain
    versions and count no launch."""
    check_resort_wrapper(wrapper, arg, fault)
