"""The benchmark's frozen plain code: copies of the port's modules as they
stood when the benchmark was defined, with the imports pointed here and the
kernel routes taken out (the prunes and the dropout take their plain
versions on every device, the mp3 decoder is absent).

They make the benchmark's inputs (the corpus, the banks, the degraded query
pool), so that a later change to the program cannot move them, and they are
the plain reference that decides ``correct``. Nothing here imports the
program: ``portbench/tests`` holds them to that.
"""
