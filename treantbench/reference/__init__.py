"""The plain reference: a group-by over the join of the benchmark's own
tables (:mod:`.join`) under a dashboard state that it derives itself from
the events (:mod:`.dashboard`).  It imports nothing of the program."""
