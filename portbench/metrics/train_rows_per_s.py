"""train_rows_per_s: the training rows that the window's steps completed
(each record's `transfers`) over the window's seconds (from the first step's
call to the last step's result on the host): transfers_per_s's reading."""

from portbench.metrics.transfers_per_s import read  # noqa: F401
