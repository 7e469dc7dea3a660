"""1:1 mapping of the reference's 54 ``#[should_panic]`` validation tests
(SURVEY §4 test-porting contract (a): panics → raised
exceptions, checked host-side outside jit).

Each table row is (reference test name, reference location, callable).
The callable must raise ``SpalinalgError`` (the base of ShapeError /
IndexError_ / ValidationError). Reference evidence:

- coo.rs:806-1121   — 17 cases (rows 1-17)
- csr.rs:466-511    —  7 cases (rows 18-24)
- csc.rs:466-511    —  7 cases (rows 25-31)
- dok.rs:843-1112   — 23 cases (rows 32-54)

Mapping notes (documented divergences):
- Rust ``new`` on compressed formats is the Python constructor.
- ``get_mut`` (mutable reference accessor) has no Python analog; its
  validation surface maps to ``remove`` — the other keyed mutating
  accessor, which performs the same bounds check (dok.rs:439-460).
- COO/DOK ``with_triplets`` length panics collapse to one ShapeError
  raised on any of the three length mismatches.
"""

import pytest

from spalinalg import (
    CooMatrix,
    CscMatrix,
    CsrMatrix,
    DokMatrix,
)
from spalinalg.errors import SpalinalgError

# (name, reference evidence, thunk)
CASES = [
    # ------------------------------------------------- coo.rs (17)
    ("coo_new_invalid_nrows", "coo.rs:819-823",
     lambda: CooMatrix(0, 1)),
    ("coo_new_invalid_ncols", "coo.rs:825-829",
     lambda: CooMatrix(1, 0)),
    ("coo_with_capacity_invalid_nrows", "coo.rs:841-845",
     lambda: CooMatrix.with_capacity(0, 1, 1)),
    ("coo_with_capacity_invalid_ncols", "coo.rs:847-851",
     lambda: CooMatrix.with_capacity(1, 0, 1)),
    ("coo_with_entries_invalid_nrows", "coo.rs:866-871",
     lambda: CooMatrix.with_entries(0, 1, [(0, 0, 1.0)])),
    ("coo_with_entries_invalid_ncols", "coo.rs:873-878",
     lambda: CooMatrix.with_entries(1, 0, [(0, 0, 1.0)])),
    ("coo_with_entries_invalid_row", "coo.rs:880-885",
     lambda: CooMatrix.with_entries(1, 2, [(1, 0, 1.0)])),
    ("coo_with_entries_invalid_col", "coo.rs:887-892",
     lambda: CooMatrix.with_entries(2, 1, [(0, 1, 1.0)])),
    ("coo_with_triplets_invalid_nrows", "coo.rs:907-913",
     lambda: CooMatrix.with_triplets(0, 1, [0], [0], [1.0])),
    ("coo_with_triplets_invalid_ncols", "coo.rs:915-921",
     lambda: CooMatrix.with_triplets(1, 0, [0], [0], [1.0])),
    ("coo_with_triplets_invalid_triplets_rowind_length", "coo.rs:923-929",
     lambda: CooMatrix.with_triplets(2, 2, [0, 1, 0], [0, 1], [1.0, 2.0])),
    ("coo_with_triplets_invalid_triplets_colind_length", "coo.rs:931-937",
     lambda: CooMatrix.with_triplets(2, 2, [0, 1], [0, 1, 0], [1.0, 2.0])),
    ("coo_with_triplets_invalid_triplets_values_length", "coo.rs:939-945",
     lambda: CooMatrix.with_triplets(2, 2, [0, 1], [0, 1], [1.0, 2.0, 3.0])),
    ("coo_with_triplets_invalid_row", "coo.rs:947-953",
     lambda: CooMatrix.with_triplets(1, 2, [1], [0], [1.0])),
    ("coo_with_triplets_invalid_col", "coo.rs:955-961",
     lambda: CooMatrix.with_triplets(2, 1, [0], [1], [1.0])),
    ("coo_push_invalid_row", "coo.rs:978-983",
     lambda: CooMatrix(1, 2).push(1, 0, 1.0)),
    ("coo_push_invalid_col", "coo.rs:985-990",
     lambda: CooMatrix(2, 1).push(0, 1, 1.0)),
    # ------------------------------------------------- csr.rs (7)
    ("csr_new_invalid_nrows", "csr.rs:470-475",
     lambda: CsrMatrix(0, 1, [0, 1, 1], [0], [1.0])),
    ("csr_new_invalid_ncols", "csr.rs:477-482",
     lambda: CsrMatrix(2, 0, [0, 1, 1], [0], [1.0])),
    ("csr_new_invalid_colptr_first_not_zero", "csr.rs:484-489",
     lambda: CsrMatrix(2, 1, [1, 1, 1], [0], [1.0])),
    ("csr_new_invalid_colptr_invalid_length", "csr.rs:491-496",
     lambda: CsrMatrix(2, 1, [0, 1], [0], [1.0])),
    ("csr_new_invalid_rowind", "csr.rs:498-503",
     lambda: CsrMatrix(2, 1, [0, 1, 1], [1], [1.0])),
    ("csr_new_unsorted_colind", "csr.rs:505-510",
     lambda: CsrMatrix(2, 2, [0, 2, 2], [1, 0], [1.0, 2.0])),
    ("csr_new_invalid_rowind_values", "csr.rs:512-517",
     lambda: CsrMatrix(2, 1, [0, 1, 1], [0], [1.0, 2.0])),
    # ------------------------------------------------- csc.rs (7)
    ("csc_new_invalid_nrows", "csc.rs:470-475",
     lambda: CscMatrix(0, 1, [0, 1], [0], [1.0])),
    ("csc_new_invalid_ncols", "csc.rs:477-482",
     lambda: CscMatrix(2, 0, [0], [0], [1.0])),
    ("csc_new_invalid_colptr_first_not_zero", "csc.rs:484-489",
     lambda: CscMatrix(1, 2, [1, 1, 1], [0], [1.0])),
    ("csc_new_invalid_colptr_invalid_length", "csc.rs:491-496",
     lambda: CscMatrix(1, 2, [0, 1], [0], [1.0])),
    ("csc_new_invalid_rowind", "csc.rs:498-503",
     lambda: CscMatrix(1, 2, [0, 1, 1], [1], [1.0])),
    ("csc_new_unsorted_rowind", "csc.rs:505-510",
     lambda: CscMatrix(2, 2, [0, 2, 2], [1, 0], [1.0, 2.0])),
    ("csc_new_invalid_rowind_values", "csc.rs:512-517",
     lambda: CscMatrix(1, 2, [0, 1, 1], [0], [1.0, 2.0])),
    # ------------------------------------------------- dok.rs (23)
    ("dok_new_invalid_nrows", "dok.rs:856-860",
     lambda: DokMatrix(0, 1)),
    ("dok_new_invalid_ncols", "dok.rs:862-866",
     lambda: DokMatrix(1, 0)),
    ("dok_with_capacity_invalid_nrows", "dok.rs:878-882",
     lambda: DokMatrix.with_capacity(0, 1, 1)),
    ("dok_with_capacity_invalid_ncols", "dok.rs:884-888",
     lambda: DokMatrix.with_capacity(1, 0, 1)),
    ("dok_with_entries_invalid_nrows", "dok.rs:903-908",
     lambda: DokMatrix.with_entries(0, 1, [(0, 0, 1.0)])),
    ("dok_with_entries_invalid_ncols", "dok.rs:910-915",
     lambda: DokMatrix.with_entries(1, 0, [(0, 0, 1.0)])),
    ("dok_with_entries_invalid_row", "dok.rs:917-922",
     lambda: DokMatrix.with_entries(1, 2, [(1, 0, 1.0)])),
    ("dok_with_entries_invalid_col", "dok.rs:924-929",
     lambda: DokMatrix.with_entries(2, 1, [(0, 1, 1.0)])),
    ("dok_with_triplets_invalid_nrows", "dok.rs:944-950",
     lambda: DokMatrix.with_triplets(0, 1, [0], [0], [1.0])),
    ("dok_with_triplets_invalid_ncols", "dok.rs:952-958",
     lambda: DokMatrix.with_triplets(1, 0, [0], [0], [1.0])),
    ("dok_with_triplets_invalid_triplets_rowind_length", "dok.rs:884-890",
     lambda: DokMatrix.with_triplets(2, 2, [0, 1, 0], [0, 1], [1.0, 2.0])),
    ("dok_with_triplets_invalid_triplets_colind_length", "dok.rs:890-896",
     lambda: DokMatrix.with_triplets(2, 2, [0, 1], [0, 1, 0], [1.0, 2.0])),
    ("dok_with_triplets_invalid_triplets_values_length", "dok.rs:896-902",
     lambda: DokMatrix.with_triplets(2, 2, [0, 1], [0, 1], [1.0])),
    ("dok_with_triplets_invalid_row", "dok.rs:902-908",
     lambda: DokMatrix.with_triplets(1, 2, [1], [0], [1.0])),
    ("dok_with_triplets_invalid_col", "dok.rs:908-914",
     lambda: DokMatrix.with_triplets(2, 1, [0], [1], [1.0])),
    ("dok_contains_invalid_row", "dok.rs:956-963",
     lambda: DokMatrix(1, 2).contains(1, 0)),
    ("dok_contains_invalid_col", "dok.rs:963-970",
     lambda: DokMatrix(2, 1).contains(0, 1)),
    ("dok_get_invalid_row", "dok.rs:978-985",
     lambda: DokMatrix(1, 2).get(1, 0)),
    ("dok_get_invalid_col", "dok.rs:985-992",
     lambda: DokMatrix(2, 1).get(0, 1)),
    ("dok_get_mut_invalid_row", "dok.rs:~1000 (get_mut → remove mapping)",
     lambda: DokMatrix(1, 2).remove(1, 0)),
    ("dok_get_mut_invalid_col", "dok.rs:~1007 (get_mut → remove mapping)",
     lambda: DokMatrix(2, 1).remove(0, 1)),
    ("dok_insert_invalid_row", "dok.rs:~1020",
     lambda: DokMatrix(1, 2).insert(1, 0, 1.0)),
    ("dok_insert_invalid_col", "dok.rs:~1027",
     lambda: DokMatrix(2, 1).insert(0, 1, 1.0)),
]

assert len(CASES) == 54, f"expected 54 parity cases, have {len(CASES)}"


@pytest.mark.parametrize(
    "name,evidence,thunk", CASES, ids=[c[0] for c in CASES]
)
def test_reference_panic_parity(name, evidence, thunk):
    with pytest.raises(SpalinalgError):
        thunk()
