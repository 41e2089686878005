"""One module per entry point of the program that a configuration drives,
named by the configuration's ``entry``: it makes the inputs, makes the timed
call and checks the answers against the plain reference."""
