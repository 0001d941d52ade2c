"""Synthetic testbeds shaped like the paper's datasets."""
