"""Operation and byte counts of the round's work, from shapes alone."""
