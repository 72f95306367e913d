"""Agent-axis sharding: the partition rules (:mod:`.rules`) and the row
split of an agent stack over a process group (:mod:`.agents`)."""
