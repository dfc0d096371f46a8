"""The port's write-side ingest pieces: `doc_op` (a document's
`index_document` op body and its embedding text) and `embedding_queue`
(the batched embedding queue)."""
