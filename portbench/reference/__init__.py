"""Plain fp32 references and the comparisons that decide ``correct``.
Nothing here imports the program (``repro_torch``)."""
