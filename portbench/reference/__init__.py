"""Plain references that decide `correct`: an exact k-NN by equal-slot
count and an OptDens sketcher, in plain torch, written from the published
semantics.  They import nothing of the program under test.  An ingest
configuration names its sketcher here (`reference`, `sketch` where it
names none)."""
