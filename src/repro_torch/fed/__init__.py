"""Federation: the asynchronous master/worker runtime (`fed.runtime`)."""
