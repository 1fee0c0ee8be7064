"""General generators, one a kind of traffic: ``tag`` (prepared batches
through the tagger) and ``query`` (tag queries against a catalog's epoch). A
mix's ``driver`` names one; its parameters are the mix's."""
