"""The runs of each kind of traffic (a traffic file's `kind`), a module each."""
