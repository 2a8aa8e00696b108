"""Data helpers of the port: the task mixtures the evaluation CLI names
(`mixtures`), the jsonl.gz / hdf5 task-spec stores (`stores`) and the CHORES
episode dataset of offline behaviour cloning (`chores`)."""
