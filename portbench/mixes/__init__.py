"""The mixes: the code that drives one kind of traffic through the program;
a traffic file names one (`traffic/<name>.json` "mix")."""
