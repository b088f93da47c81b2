"""The tolerance the port's per-bucket telemetry rows are held to against
the JAX package's (shared by the executor and runtime tests)."""
import numpy as np


def assert_telemetry_close(got: dict, want: dict, quantized: bool):
    """Rows [nnz, wire, coverage, EF norm]: nnz and wire equal without
    QSGD, nnz within 1e-3 relative with it (a level may flip at a scale's
    last ulp, and the wire follows the nnz); coverage and EF norm at rtol
    1e-5 (sums of squares in another order)."""
    assert set(got) == set(want) and got
    for name, row in got.items():
        row, ref = np.asarray(row, np.float64), np.asarray(want[name],
                                                           np.float64)
        assert row.shape == ref.shape == (4,)
        if quantized:
            np.testing.assert_allclose(row[:2], ref[:2], rtol=1e-3)
        else:
            np.testing.assert_array_equal(row[:2], ref[:2])
        np.testing.assert_allclose(row[2:], ref[2:], rtol=1e-5)
        assert 0 < row[2] <= 1 + 1e-6 and row[3] >= 0
