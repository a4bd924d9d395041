"""The plain CRUSH mapper the benchmark's remap cells are judged by."""
