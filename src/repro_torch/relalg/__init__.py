"""Relational-algebra substrate: fixed-shape columnar tables on device."""
from .encoding import PAD_ID, Vocab
from .guard import (TransferLedger, count_transfers, forbid_transfers,
                    host_get, host_int)
from .table import Table, bucket_cap, round_cap, shrink_to_fit
from .ops import (DEFAULT_DEDUP, append_rows, compact, dedup_rows, distinct,
                  distinct_rows, distinct_rows_hashed, equi_join, project,
                  project_as, rename, select_eq, select_mask, select_neq,
                  sort_lex, union)

__all__ = [
    "DEFAULT_DEDUP", "PAD_ID", "TransferLedger", "Vocab", "Table",
    "append_rows", "bucket_cap", "compact", "count_transfers", "dedup_rows",
    "distinct", "distinct_rows", "distinct_rows_hashed", "equi_join",
    "forbid_transfers", "host_get", "host_int", "project", "project_as",
    "rename", "round_cap", "select_eq", "select_mask", "select_neq",
    "shrink_to_fit", "sort_lex", "union",
]
